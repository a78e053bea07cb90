"""Times the port's conversion-path and attention kernels, one JSON line.

    python quickvc_tpu_torch/scripts/kernel_times.py [--root CHECKOUT] [--iters N]

K1 (log-mel, (1, 144000) at n_fft/hop 1280/320), K2 (packed attention,
(8, 250, 768)), K3 (the decoder head at n_fft/hop 16/4, (32, 5001, 9) x2),
K9 ((8, 250, 12*128), 64 true lanes a head), K10 ((8, 12, 250, 64)) and K8
(one HuBERT layer, (16, 300, 768)) at the shapes ``chip_smoke.py`` checks,
with ``F.scaled_dot_product_attention`` on the same heads beside K2/K9/K10;
inputs from a fixed seed, through the ops' dispatchers. Each entry is the
mean of ``--iters`` calls after ``--warmup``, timed with CUDA events, and
under ``device_ms`` the device time of the kernels those calls launched
(:func:`device_ms`), which leaves out the host's enqueue time: a kernel of
a few tens of microseconds can run faster than the Python wrapper enqueues
it. ``--device cpu`` times the plain versions on the host clock and has no
``device_ms``.

``--root`` imports ``quickvc_tpu_torch`` from another checkout of the repo
(its kernels build there), so that two versions are timed in turns on one
card in one call (A B B A, one process each). ``chip_smoke.py`` cannot do
this: it imports the package of its own checkout, and one run of it takes
minutes of card time where this takes seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn`` on the card: the self
    device time of every kernel that ``iters`` calls launch
    (torch.profiler), without the host's time to enqueue them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / iters / 1e3


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="checkout to import quickvc_tpu_torch from")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=5)
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch.nn.functional as F

    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.ops import fused_attention as fa
    from quickvc_tpu_torch.ops import fused_istft, fused_mel
    from quickvc_tpu_torch.ops import fused_transformer as ft
    from quickvc_tpu_torch.scripts import time_ms
    from quickvc_tpu_torch.utils.device import resolve_device
    from quickvc_tpu_torch.utils.weights import init_random_

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"package": os.path.dirname(os.path.dirname(fa.__file__))}
    if dev.type == "cuda":
        out["device_ms"] = {}

    def ms(name: str, fn) -> None:
        out[name] = time_ms(fn, dev, args.iters, args.warmup)
        if dev.type == "cuda":
            out["device_ms"][name] = device_ms(fn, args.iters)

    y = 0.3 * torch.randn(1, 144000, device=dev, generator=g)
    ms("K1", lambda: fused_mel.wave_to_mel(y, 16000, 1280, 320, 1280, 80))
    q, k, v = torch.randn(8, 250, 3 * 768, device=dev, generator=g).chunk(3, -1)
    heads = [z.reshape(8, 250, 12, 64).transpose(1, 2).contiguous() for z in (q, k, v)]
    ms("K2", lambda: fa.attention_packed(q, k, v, 12, 0.125))
    ms("K10", lambda: fa.attention(*heads, 0.125))
    ms("sdpa_64", lambda: F.scaled_dot_product_attention(*heads, scale=0.125))
    xs = [F.pad(z.reshape(8, 250, 12, 64), (0, 64)).reshape(8, 250, 1536) for z in (q, k, v)]
    padded = [z.reshape(8, 250, 12, 128).transpose(1, 2) for z in xs]
    ms("K9", lambda: fa.attention_packed_aligned(*xs, 12, 0.125))
    ms("sdpa_128", lambda: F.scaled_dot_product_attention(*padded, scale=0.125))
    spec = 0.5 * torch.randn(32, 18, 5001, device=dev, generator=g).transpose(1, 2)
    lm, ph = spec[..., :9], spec[..., 9:]
    ms("K3", lambda: fused_istft.polar_inverse_stft(lm, ph, 16, 4))
    layer = init_random_(TransformerLayer(use_fused_layer=True), 8).to(dev).eval()
    layer.requires_grad_(False)
    x = torch.randn(16, 300, 768, device=dev, generator=g)
    ms("K8", lambda: ft.transformer_layer(x, layer))
    if dev.type == "cuda":
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print("kernel_times " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
