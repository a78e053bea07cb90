"""Times the port's conversion-path, attention and discriminator kernels, one JSON line.

    python quickvc_tpu_torch/scripts/kernel_times.py [--root CHECKOUT] [--iters N]

K1 (log-mel, (1, 144000) at n_fft/hop 1280/320), K2 (packed attention,
(8, 250, 768)), K3 (the decoder head at n_fft/hop 16/4, (32, 5001, 9) x2),
K9 ((8, 250, 12*128), 64 true lanes a head), K10 ((8, 12, 250, 64)) and K8
(one HuBERT layer, (16, 300, 768)) at the shapes ``chip_smoke.py`` checks,
with ``F.scaled_dot_product_attention`` on the same heads beside K2/K9/K10;
inputs from a fixed seed, through the ops' dispatchers. On the card also:

- K5 (k=5 conv + LeakyReLU), K5's dx and K6 (dW) at the fifth conv of the
  period discriminators p = 2 and 11 in the paired D phase, x (128, 64,
  1024) and (704, 12, 1024), through their kernel wrappers, with cuDNN's
  ``F.conv1d``, ``conv1d_input`` and ``conv1d_weight`` on the same inputs
  beside them (TF32 off for both cuBLAS and cuDNN);
- the rate ``mma.sync`` TF32 reaches on register operands
  (``csrc/mma_rate.cu``, ``mma_sync_tf32_tflops``), the ceiling of the
  kernels built on it;
- one D phase of the full-width multi-period discriminator at the training
  batch (32 real||fake pairs of 10,240 samples: paired forward, loss,
  parameter gradients) with its fifth convs on K5/K6 (``D_phase_fused``)
  and on cuDNN (``D_phase_default``), 5 calls each, in CUDA events only
  (the profiler counts the kernels of autograd's backward ops twice).

``--device cpu`` leaves these out. Each entry is the mean of ``--iters``
calls after ``--warmup``, timed with CUDA events, and
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


# x (N, R, C) at the fifth conv of the period discriminators p = 2 and 11
# (ops.fused_disc_conv.disc_conv5_shapes(64, 10240))
CONV5_SHAPES = {2: (128, 64, 1024), 11: (704, 12, 1024)}


def conv5_times(ms, dev: torch.device, g: torch.Generator) -> None:
    """K5, K5's dx and K6 beside cuDNN at CONV5_SHAPES, inputs scaled so
    that y, dx and dW are O(1)."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    for p, (n, rows, c) in CONV5_SHAPES.items():
        x = torch.randn(n, rows, c, device=dev, generator=g)
        k = torch.randn(5, c, c, device=dev, generator=g) / c ** 0.5 / 5 ** 0.5
        b = 0.1 * torch.randn(c, device=dev, generator=g)
        dym = torch.randn(n, rows, c, device=dev, generator=g) / (n * rows) ** 0.5
        k_flip = k.flip(0).transpose(1, 2).contiguous()
        x_ncr = x.transpose(1, 2).contiguous()     # cuDNN's (N, C, R)
        w_oik = k.permute(2, 1, 0).contiguous()    # (C_out, C_in, 5)
        dym_ncr = dym.transpose(1, 2).contiguous()
        ms(f"K5_p{p}", lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1))
        ms(f"cudnn_fwd_p{p}", lambda: F.leaky_relu(F.conv1d(x_ncr, w_oik, b, padding=2), 0.1))
        ms(f"K5_dx_p{p}", lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0))
        ms(f"cudnn_dx_p{p}", lambda: torch.nn.grad.conv1d_input(x_ncr.shape, w_oik, dym_ncr,
                                                                padding=2))
        ms(f"K6_p{p}", lambda: fdc.conv5_dw_kernel(x, dym))
        ms(f"cudnn_dw_p{p}", lambda: torch.nn.grad.conv1d_weight(x_ncr, w_oik.shape, dym_ncr,
                                                                 padding=2))


def disc_phase_times(out: dict, dev: torch.device) -> None:
    """One D phase with the fifth convs fused (K5/K6) and on cuDNN, same
    seeded weights and waves, into ``out`` (CUDA events)."""
    from quickvc_tpu_torch.losses import discriminator_loss
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.scripts import time_ms
    from quickvc_tpu_torch.utils.weights import init_random_

    base = init_random_(MultiPeriodDiscriminator(), 3).to(dev)
    fused = MultiPeriodDiscriminator(fused_conv5=True).to(dev)
    fused.load_state_dict(base.state_dict())
    g = torch.Generator(device=dev).manual_seed(4)
    y, y_hat = (0.3 * torch.randn(32, 1, 10240, device=dev, generator=g) for _ in range(2))

    def d_phase(net):
        logits_r, logits_g, _, _ = net(y, y_hat, pair=True)
        loss = discriminator_loss(logits_r, logits_g)[0]
        return torch.autograd.grad(loss, list(net.parameters()))

    for name, net in (("D_phase_fused", fused), ("D_phase_default", base)):
        out[name] = time_ms(lambda: d_phase(net), dev, 5, 1)


def mma_tf32_tflops(dev: torch.device, iters: int) -> dict | None:
    """TFLOP/s of mma.sync.m16n8k8 TF32 over four blocks of 8 warps an SM,
    from CUDA events and from profiler device time; None where the package
    has no such yardstick."""
    from quickvc_tpu_torch.ops._cuda import library
    from quickvc_tpu_torch.scripts import time_ms

    fn = getattr(library(), "qvc_mma_tf32_rate", None)
    if fn is None:
        return None
    blocks, rounds = 4 * torch.cuda.get_device_properties(dev).multi_processor_count, 4096
    buf = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        fn(buf.data_ptr(), blocks, rounds, stream)

    flops = blocks * 8 * rounds * 8 * 2 * 16 * 8 * 8
    calls = max(iters // 10, 10)
    return {"events": flops / (time_ms(run, dev, calls, 2) * 1e-3) / 1e12,
            "device": flops / (device_ms(run, calls) * 1e-3) / 1e12}


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
    torch.backends.cudnn.allow_tf32 = False
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
        conv5_times(ms, dev, g)
        out["mma_sync_tf32_tflops"] = mma_tf32_tflops(dev, args.iters)
        disc_phase_times(out, dev)
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print("kernel_times " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
