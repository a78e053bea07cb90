"""Times the port's conversion-path, attention and discriminator kernels, one JSON line.

    python quickvc_tpu_torch/scripts/kernel_times.py [--root CHECKOUT] [--iters N]

K1 (log-mel, (1, 144000) at n_fft/hop 1280/320, beside the ``torch.stft``
chain that computes the same log-mel, ``K1_library``; also at 2048/512, its
other FFT-route size ``chip_smoke.py`` checks, and at 800/200 and 4096/1024,
its dense route in one bin chunk and in three), K2 (packed attention,
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
- K11 at the int8 probe's shape (16384 x 12288) @ (12288 x 3072), s8 and
  bf16, with ``torch._int_mm``, bf16 ``torch.matmul`` and, where this torch
  has it, ``torch.mm(..., out_dtype=torch.float32)`` (K11's own function)
  beside them; where the package has K11's bring-up probes
  (``int8_mm._mm_probe``), the split too: the mainloop alone
  (``_no_store``), the tensor cores alone on stale shared memory
  (``_no_load``, nothing loaded or stored) and a grid of one block a tile
  (``_tile_a_block``), with and without the store; and for bf16 the largest
  error against ``mm_reference`` (``K11_bf16_probe_err``) at (200, 96) @
  (96, 72) and at the probe shape of the product and of the body without
  its accumulator fences (``no_operand_fence``);
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


def device_kernels(fn) -> list[str]:
    """Names of the kernels one call of ``fn`` runs on the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages() if e.self_device_time_total > 0)


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


def mel_times(ms, dev: torch.device, y: torch.Tensor) -> None:
    """K1 at 1280/320 beside its library chain (reflect pad, ``torch.stft``,
    magnitude, mel product, log clamp), and at the other sizes K1's checks
    take."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.dsp.mel import mel_filterbank
    from quickvc_tpu_torch.dsp.stft import hann_window
    from quickvc_tpu_torch.ops import fused_mel

    fb = torch.as_tensor(mel_filterbank(16000, 1280, 80), device=dev)
    win = torch.as_tensor(hann_window(1280), device=dev)

    def library():
        yp = F.pad(y[:, None], (480, 480), mode="reflect")[:, 0]
        z = torch.stft(yp, 1280, 320, 1280, win, center=False, return_complex=True)
        return torch.log(torch.clamp(fb @ torch.sqrt(z.abs() ** 2 + 1e-6), min=1e-5))

    ms("K1", lambda: fused_mel.wave_to_mel(y, 16000, 1280, 320, 1280, 80))
    ms("K1_library", library)
    for n_fft, hop in ((2048, 512), (800, 200), (4096, 1024)):
        ms(f"K1_{n_fft}", lambda n_fft=n_fft, hop=hop: fused_mel.wave_to_mel(
            y, 16000, n_fft, hop, n_fft, 80))


def gemm_times(ms, dev: torch.device, g: torch.Generator) -> dict:
    """K11 at the int8 probe's shape beside its library calls, and the
    bring-up probes where the package has them; returns notes on what this
    torch lacks and the probes' errors."""
    from quickvc_tpu_torch.ops import int8_mm

    m, k, n = 16384, 12288, 3072
    a8 = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=g)
    b8 = torch.randint(-127, 128, (k, n), device=dev, dtype=torch.int8, generator=g)
    abf, bbf = ((x.float() / 127.0).bfloat16() for x in (a8, b8))
    ms("K11_s8", lambda: int8_mm.mm_kernel(a8, b8))
    ms("int_mm_s8", lambda: torch._int_mm(a8, b8))
    ms("K11_bf16", lambda: int8_mm.mm_kernel(abf, bbf))
    ms("matmul_bf16", lambda: torch.matmul(abf, bbf))
    notes = {}
    try:
        torch.mm(abf[:64, :64], bbf[:64, :64], out_dtype=torch.float32)
        ms("mm_out_f32_bf16", lambda: torch.mm(abf, bbf, out_dtype=torch.float32))
    except (TypeError, RuntimeError) as e:
        notes["mm_out_f32_bf16"] = f"not timed: {type(e).__name__}: {str(e)[:120]}"
    probe = getattr(int8_mm, "_mm_probe", None)
    if probe is None:
        return notes
    tiles = -(-m // 128) * -(-n // 256)
    for name, a, b in (("s8", a8, b8), ("bf16", abf, bbf)):
        ms(f"K11_{name}_no_store", lambda a=a, b=b: probe(a, b, "no_store"))
        ms(f"K11_{name}_no_load", lambda a=a, b=b: probe(a, b, "no_load"))
        ms(f"K11_{name}_tile_a_block", lambda a=a, b=b: probe(a, b, "product", tiles))
        ms(f"K11_{name}_tile_a_block_no_store",
           lambda a=a, b=b: probe(a, b, "no_store", tiles))
    small = (abf[:200, :96].contiguous(), bbf[:96, :72].contiguous())
    notes["K11_bf16_probe_err"] = {
        variant: [float((probe(a, b, variant) - int8_mm.mm_reference(a, b)).abs().max())
                  for a, b in (small, (abf, bbf))]
        for variant in ("product", "no_operand_fence")}
    return notes


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
    from quickvc_tpu_torch.ops import fused_istft
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

    mel_times(ms, dev, 0.3 * torch.randn(1, 144000, device=dev, generator=g))
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
        out["notes"] = gemm_times(ms, dev, g)
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
