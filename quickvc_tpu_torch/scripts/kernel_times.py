"""Times the port's conversion-path, attention and discriminator kernels, one JSON line.

    python quickvc_tpu_torch/scripts/kernel_times.py [--root CHECKOUT] [--iters N]

K1 (log-mel, (1, 144000) at n_fft/hop 1280/320, beside the ``torch.stft``
chain that computes the same log-mel, ``K1_library``; also at 2048/512, its
other FFT-route size ``chip_smoke.py`` checks, and at 800/200 and 4096/1024,
its dense route in one bin chunk and in three), K2 (packed attention,
(8, 250, 768)), K3 (the decoder head at n_fft/hop 16/4 on the decoder's
strided views: the conversion batch (32, 5001, 9) x2, the streaming window
(32, 5761), the live windows at 64 streams (256, 1601 / 1361) and at one
(4, 1361); on the card also, at the conversion shape, its ``torch.istft``
chain, its device time with the L2 flushed before each launch and its
bring-up probes, and the wrapper's host µs a call at one stream's live
window: :func:`istft_times`),
K9 ((8, 250, 12*128), 64 true lanes a head), K10 ((8, 12, 250, 64)) and K8
(one HuBERT layer, (16, 300, 768)) at the shapes ``chip_smoke.py`` checks,
with ``F.scaled_dot_product_attention`` on the same heads beside K2/K9/K10;
inputs from a fixed seed, through the ops' dispatchers. On the card also:

- K4 (the halo'd spectrogram) at the training batch, (32, 512*320 + 960)
  -> (32, 512, 641);
- K7 (HuBERT's extractor front) at the encoding batch's wave (16, 96080)
  -> (16, 9607, 512), beside its cuDNN chain (conv0, GroupNorm over its
  output, GELU, conv1, GELU: ``K7_library``), and K8's library layer,
  ``nn.TransformerEncoderLayer`` with the same weights (``K8_library``);

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
import time

import torch


def device_kernels(fn) -> list[str]:
    """Names of the kernels one call of ``fn`` runs on the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages() if e.self_device_time_total > 0)


def device_ms(fn, iters: int, between=None, only: str | None = None) -> float:
    """Mean device milliseconds per call of ``fn`` on the card: the self
    device time of every kernel that ``iters`` calls launch
    (torch.profiler), without the host's time to enqueue them. ``between``
    runs before each call (e.g. an L2 flush); ``only`` then keeps the
    kernels whose names hold it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if only is None or only in e.key) / iters / 1e3


def l2_flush(dev: torch.device):
    """A call that writes 128 MB, more than the H100's 50 MB L2, so that the
    next kernel reads its inputs from device memory."""
    buf = torch.empty(32 * 2 ** 20, device=dev)
    return buf.zero_


def host_us(fns: dict, iters: int, repeats: int = 7) -> dict:
    """Host microseconds a call of each of ``fns`` takes to enqueue its
    work: the host clock over ``iters`` calls that nothing waits for (then a
    synchronize, outside the reading), the least of ``repeats`` readings,
    the functions read in turn within each repeat (the host's clock moves
    with its other load, so only readings taken together compare)."""
    readings = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            readings[name].append((t1 - t0) / iters * 1e6)
    return {name: min(r) for name, r in readings.items()}


# K3's shapes (rows = 4 bands x batch, 20 frames a unit frame + 1): the
# conversion batch, the streaming window, the live windows at 64 streams
# and the smaller one at 1 stream
ISTFT_SHAPES = {"K3": (32, 5001), "K3_stream": (32, 5761), "K3_live64_1601": (256, 1601),
                "K3_live64_1361": (256, 1361), "K3_live1": (4, 1361)}


def istft_times(ms, out: dict, dev: torch.device, g: torch.Generator, iters: int) -> None:
    """K3 (on the decoder's strided views) at ISTFT_SHAPES; beside it at the
    conversion shape the ``torch.istft`` chain (``K3_library``), the L2-cold
    device time (``K3_l2_cold``), and at the live window of one stream the
    wrapper's host µs a call (``K3_host_us_live1``) in turns with that of
    allocating its output, ``empty_host_us``, the yardstick of the host's
    speed at the time."""
    from quickvc_tpu_torch.ops import fused_istft

    views = {}
    for name, (rows, f) in ISTFT_SHAPES.items():
        spec = 0.5 * torch.randn(rows, 18, f, device=dev, generator=g).transpose(1, 2)
        views[name] = spec[..., :9], spec[..., 9:]
        ms(name, lambda v=views[name]: fused_istft.polar_inverse_stft(*v, 16, 4))
    if dev.type != "cuda":
        return
    lm, ph = views["K3"]
    hann = torch.hann_window(16, device=dev)

    def library():
        z = torch.polar(torch.exp(lm), torch.pi * torch.sin(ph)).transpose(1, 2)
        return torch.istft(z, 16, 4, 16, hann, center=True)

    ms("K3_library", library)
    out["device_ms"]["K3_l2_cold"] = device_ms(
        lambda: fused_istft.polar_inverse_stft(lm, ph, 16, 4), iters,
        between=l2_flush(dev), only="polar_istft")
    lm1, ph1 = views["K3_live1"]
    host = host_us({"K3": lambda: fused_istft.polar_inverse_stft_kernel(lm1, ph1, 16, 4),
                    "empty": lambda: torch.empty(lm1.shape[0], 4 * 1360, device=dev)},
                   5 * iters)
    out["K3_host_us_live1"], out["empty_host_us"] = host["K3"], host["empty"]


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


def encoding_times(ms, dev: torch.device, g: torch.Generator, layer, x) -> None:
    """K7 beside its cuDNN chain at the encoding batch's wave, and the
    library layer beside K8 (timed by the caller) on the same x."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_extractor as fe

    c = 512
    wav = 0.3 * torch.randn(16, 96080, device=dev, generator=g)
    w0 = 0.3 * torch.randn(c, 1, 10, device=dev, generator=g)
    gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
    beta = 0.1 * torch.randn(c, device=dev, generator=g)
    w1 = torch.randn(c, c, 3, device=dev, generator=g) / (3 * c) ** 0.5

    def k7_library():
        y = F.gelu(F.group_norm(F.conv1d(wav[:, None], w0, stride=5), c, gamma, beta, 1e-5))
        return F.gelu(F.conv1d(y, w1, stride=2)).transpose(1, 2)

    ms("K7", lambda: fe.extractor_front(wav, w0, gamma, beta, w1))
    ms("K7_library", k7_library)
    lib_layer = torch.nn.TransformerEncoderLayer(768, 12, 3072, dropout=0.0, activation="gelu",
                                                 batch_first=True).to(dev).eval()
    lib_layer.load_state_dict(layer.state_dict())
    lib_layer.requires_grad_(False)

    def k8_library():
        with torch.inference_mode():
            return lib_layer(x)

    ms("K8_library", k8_library)


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
    istft_times(ms, out, dev, g, args.iters)
    layer = init_random_(TransformerLayer(use_fused_layer=True), 8).to(dev).eval()
    layer.requires_grad_(False)
    x = torch.randn(16, 300, 768, device=dev, generator=g)
    ms("K8", lambda: ft.transformer_layer(x, layer))
    if dev.type == "cuda":
        from quickvc_tpu_torch.ops import fused_mel

        y4 = 0.3 * torch.randn(32, 512 * 320 + 960, device=dev, generator=g)
        ms("K4", lambda: fused_mel.wave_to_spec_halo(y4, 1280, 320, 1280))
        del y4
        encoding_times(ms, dev, g, layer, x)
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
