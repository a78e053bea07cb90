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
  beside them (TF32 off for both cuBLAS and cuDNN); and the same in bf16
  (their bf16 mode, on the TMA + wgmma body, in turns with the mma.sync
  body it replaced at these shapes, called by its entry, and cuDNN's bf16
  calls: ``K5_bf16_p2_a``, ``K5_bf16_p2_mma_sync_a``, ``K5_bf16_p2_cudnn_a``,
  ...; each call's plan with the body's blocks an SM, registers and local
  bytes, ``conv5_bf16_p2_plans``; the body at every tile width and K6 split
  2 ways, ``K5_bf16_p2_bn128``, ``K6_bf16_p2_bn192_s2``, ...);
- in turns (library, kernel, kernel, library: ``_a`` and ``_b``), K8's
  bf16 mode at (16, 300, 768) beside ``nn.TransformerEncoderLayer`` in
  bf16 (``K8_bf16``, ``K8_bf16_library``; ``K8_bf16_kernels``: its device
  time by kernel name), and the speaker LSTM's bf16 recurrence kernels at
  a layer of the training batch's, gates (32, 512, 4 x 256), beside one
  layer of cuDNN's bf16 LSTM (``cudnn_lstm_layer``) on its (32, 512, 80)
  input: the forward of one layer (``lstm_bf16``, ``lstm_bf16_library``:
  cuDNN's forward; ``lstm_bf16_host_us``: the host µs a call of each takes
  to enqueue), the backward alone (``lstm_bf16_backward``,
  ``lstm_bf16_backward_library``: cuDNN's forward and backward) and like
  for like, a layer's forward and backward kernels against cuDNN's forward
  and backward (``lstm_bf16_layer_step``); and the whole three-layer
  forward from the mel, layer 0's projection included, against cuDNN's
  3-layer bf16 ``nn.LSTM`` forward (``cudnn_lstm``): one launch of the
  stack kernel (``lstm_stack_bf16``, where the package has it) and the
  layers one launch each with their projections between
  (``lstm_layers_bf16``);
- in turns, K2, K10 and K9's bf16 modes at (8, 250, 768), (8, 12, 250, 64)
  and (8, 250, 12*128) beside bf16 SDPA on the same heads
  (``K2_bf16``, ``K10_bf16``, ``K9_bf16``); where the package has
  ``bf16_attention_plan``, the plan of each shape the bf16 body runs at
  (``attention_bf16_plans``: K2's conversion, live and ragged shapes, K9,
  K10, K8's attention) for the TMA + wgmma body and for the mma.sync body,
  each with its CTAs an SM, registers and shared memory on the card and
  the waves those make;
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
  and on cuDNN (``D_phase_default``), 20 calls each, in CUDA events only
  (the profiler counts the kernels of autograd's backward ops twice); and
  both on bf16 waves (``D_phase_fused_bf16``, ``D_phase_default_bf16``),
  with the device time of the fused bf16 phase's K5/K6 kernels and split-K
  sums (``D_phase_fused_bf16_conv5_device_ms``).

``--device cpu`` leaves these out; ``--only bf16`` runs the bf16 turns
alone (K2/K9/K10 bf16, K8 bf16 and the LSTM rows), seconds of card time;
``--only conv5`` K5/K6 bf16's turns with the plans' sweep (also at p = 7),
and the D phases; ``--only lstm`` the speaker LSTM's three-layer bf16
backward at the training batch, the package's path (one launch of the
backward stack kernel where it has one) in turns with the three layers one
launch each (``lstm_backward_a`` against ``lstm_backward_library_a``, ...)
and with cuDNN's 3-layer bf16 backward (``lstm_backward_cudnn3_*``);
``--only extractor`` K7's bf16 mode at the encoding batch in turns with
cuDNN's bf16 chain (``K7_bf16_*``; ``K7_bf16_body`` names the body the
route ran). With ``--root`` on the parent checkout, ``--only lstm`` and
``--only extractor`` time the parent's bodies: run parent, change,
change, parent in one call. Each entry is the mean of ``--iters``
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


def device_breakdown(fn, iters: int) -> dict:
    """Mean device milliseconds a call of ``fn`` spends in each kernel it
    launches, by the kernel's name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.self_device_time_total > 0}


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


def conv5_times(ms, dev: torch.device, g: torch.Generator, out: dict | None = None,
                bf16_only: bool = False, shapes: dict = CONV5_SHAPES) -> None:
    """K5, K5's dx and K6 beside cuDNN at CONV5_SHAPES, inputs scaled so
    that y, dx and dW are O(1); their bf16 modes in turns with the mma.sync
    body and cuDNN's bf16 calls (:func:`conv5_bf16_turns`; ``bf16_only``:
    those alone; ``shapes`` the periods' x)."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    for p, (n, rows, c) in shapes.items():
        x = torch.randn(n, rows, c, device=dev, generator=g)
        k = torch.randn(5, c, c, device=dev, generator=g) / c ** 0.5 / 5 ** 0.5
        b = 0.1 * torch.randn(c, device=dev, generator=g)
        dym = torch.randn(n, rows, c, device=dev, generator=g) / (n * rows) ** 0.5
        k_flip = k.flip(0).transpose(1, 2).contiguous()
        x_ncr = x.transpose(1, 2).contiguous()     # cuDNN's (N, C, R)
        w_oik = k.permute(2, 1, 0).contiguous()    # (C_out, C_in, 5)
        dym_ncr = dym.transpose(1, 2).contiguous()
        conv5_bf16_turns(ms, p, *(z.bfloat16() for z in (x, k, b, dym)), out=out)
        if bf16_only:
            continue
        ms(f"K5_p{p}", lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1))
        ms(f"cudnn_fwd_p{p}", lambda: F.leaky_relu(F.conv1d(x_ncr, w_oik, b, padding=2), 0.1))
        ms(f"K5_dx_p{p}", lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0))
        ms(f"cudnn_dx_p{p}", lambda: torch.nn.grad.conv1d_input(x_ncr.shape, w_oik, dym_ncr,
                                                                padding=2))
        ms(f"K6_p{p}", lambda: fdc.conv5_dw_kernel(x, dym))
        ms(f"cudnn_dw_p{p}", lambda: torch.nn.grad.conv1d_weight(x_ncr, w_oik.shape, dym_ncr,
                                                                 padding=2))


def conv5_mma_sync(x: torch.Tensor, kernel: torch.Tensor, bias, slope: float) -> torch.Tensor:
    """K5 bf16 on the mma.sync body (``csrc/fused_disc_conv.cu``), by its C
    entry whatever the shape: the wrapper sends the period shapes to the
    wgmma body, and this is the body it replaced there, for turns on the
    same inputs. Not counted as a launch of the port."""
    from quickvc_tpu_torch.ops._cuda import check, library, stream_ptr

    n, rows, c_in = x.shape
    c_out = kernel.shape[2]
    y = torch.empty((n, rows, c_out), device=x.device, dtype=x.dtype)
    check(library().qvc_conv5_lrelu_bf16(
        x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), n, rows, c_in, c_out, float(slope), stream_ptr(x)), "conv5 mma.sync")
    return y


def conv5_dw_mma_sync(x: torch.Tensor, dym: torch.Tensor) -> torch.Tensor:
    """K6 bf16 on the mma.sync body by its C entry, split as ``dw_plan`` on
    ``BF16_TILING`` plans it (see :func:`conv5_mma_sync`)."""
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc
    from quickvc_tpu_torch.ops._cuda import check, device_sms, library, stream_ptr

    n, rows, c_in = x.shape
    c_out = dym.shape[2]
    plan = fdc.dw_plan(n, rows, c_in, c_out, device_sms(x.device.index or 0), fdc.BF16_TILING)
    dw = torch.empty((5, c_in, c_out), device=x.device, dtype=x.dtype)
    ws = torch.empty(max(plan.workspace, 1), device=x.device, dtype=torch.float32)
    check(library().qvc_conv5_dw_bf16(x.data_ptr(), dym.data_ptr(), dw.data_ptr(),
                                      ws.data_ptr(), n, rows, c_in, c_out, plan.splits,
                                      plan.k_chunk, stream_ptr(x)), "conv5 dW mma.sync")
    return dw


def conv5_wgmma_at(dw: bool, bn: int, splits: int, *ins) -> torch.Tensor:
    """K5 bf16 (``dw`` False: x, filter, bias, slope) or K6 bf16 (x, dym) on
    the wgmma body by its C entry at a given tile width and split, for the
    plan's sweep. Not counted as a launch of the port."""
    from quickvc_tpu_torch.ops._cuda import check, library, stream_ptr

    x = ins[0]
    n, rows, c_in = x.shape
    c_out = ins[1].shape[-1]
    if not dw:
        kernel, bias, slope = ins[1:]
        y = torch.empty((n, rows, c_out), device=x.device, dtype=x.dtype)
        check(library().qvc_conv5_lrelu_bf16_wgmma(
            x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), n, rows, c_in, c_out, float(slope), bn, stream_ptr(x)), "conv5 wgmma")
        return y
    k_tiles = -(-n * rows // 64)
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)
    out = torch.empty((5, c_in, c_out), device=x.device, dtype=x.dtype)
    ws = torch.empty(max(splits * 5 * c_in * c_out if splits > 1 else 0, 1), device=x.device,
                     dtype=torch.float32)
    check(library().qvc_conv5_dw_bf16_wgmma(x.data_ptr(), ins[1].data_ptr(), out.data_ptr(),
                                            ws.data_ptr(), n, rows, c_in, c_out, bn, splits,
                                            per * 64, stream_ptr(x)), "conv5 dW wgmma")
    return out


def conv5_bf16_turns(ms, p: int, x, k, b, dym, out: dict | None = None) -> None:
    """K5 bf16 (forward, dx) and K6 bf16 at period p through the wrappers,
    in turns with the mma.sync body and cuDNN's bf16 calls on the same bf16
    inputs: cuDNN, mma.sync, kernel, kernel, mma.sync, cuDNN (``K5_bf16_p2``
    + ``_cudnn_a``, ``_mma_sync_a``, ``_a``, ``_b``, ``_mma_sync_b``,
    ``_cudnn_b``; ``K5_bf16_dx_p2``, ``K6_bf16_p2``). Where the package has
    the wgmma body, ``out`` gets each call's plan and the body's blocks an
    SM, registers and local bytes, and ``ms`` the wgmma body at every tile
    width (``K5_bf16_p2_bn128``, ...) and K6 at 128-256 also split 2, 3 and
    4 ways (``K6_bf16_p2_bn128_s2``), the plan's sweep."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    k_flip = k.flip(0).transpose(1, 2).contiguous()
    x_ncr, dym_ncr = x.transpose(1, 2).contiguous(), dym.transpose(1, 2).contiguous()
    w_oik = k.permute(2, 1, 0).contiguous()
    calls = {
        f"K5_bf16_p{p}": (lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1),
                          lambda: conv5_mma_sync(x, k, b, 0.1),
                          lambda: F.leaky_relu(F.conv1d(x_ncr, w_oik, b, padding=2), 0.1)),
        f"K5_bf16_dx_p{p}": (lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0),
                             lambda: conv5_mma_sync(dym, k_flip, None, 1.0),
                             lambda: torch.nn.grad.conv1d_input(x_ncr.shape, w_oik, dym_ncr,
                                                                padding=2)),
        f"K6_bf16_p{p}": (lambda: fdc.conv5_dw_kernel(x, dym),
                          lambda: conv5_dw_mma_sync(x, dym),
                          lambda: torch.nn.grad.conv1d_weight(x_ncr, w_oik.shape, dym_ncr,
                                                              padding=2))}
    for name, (kernel, mma, cudnn) in calls.items():
        for tag, fn in (("_cudnn_a", cudnn), ("_mma_sync_a", mma), ("_a", kernel),
                        ("_b", kernel), ("_mma_sync_b", mma), ("_cudnn_b", cudnn)):
            ms(name + tag, fn)
    if not hasattr(fdc, "conv5_wgmma_plan"):
        return
    n, rows, c = x.shape
    plans = {"forward": fdc.conv5_wgmma_plan(False, n, rows, c, c),
             "dw": fdc.conv5_wgmma_plan(True, n, rows, c, c)}
    if out is not None:
        out[f"conv5_bf16_p{p}_plans"] = {
            key: plan._asdict() | {"workspace_bytes": 4 * plan.workspace}
            | fdc.conv5_wgmma_attributes(key == "dw", plan.bn) for key, plan in plans.items()}
    for bn in (64, 128, 192, 256):
        ms(f"K5_bf16_p{p}_bn{bn}", lambda bn=bn: conv5_wgmma_at(False, bn, 1, x, k, b, 0.1))
        for s in (1, 2, 3, 4) if bn > 64 else (1,):
            ms(f"K6_bf16_p{p}_bn{bn}" + (f"_s{s}" if s > 1 else ""),
               lambda bn=bn, s=s: conv5_wgmma_at(True, bn, s, x, dym))


def disc_phase_times(out: dict, dev: torch.device) -> None:
    """One D phase with the fifth convs fused (K5/K6) and on cuDNN, same
    seeded weights and waves, into ``out`` (CUDA events); then both on the
    waves in bf16 (K5/K6's bf16 mode against cuDNN's bf16 convs)."""
    from quickvc_tpu_torch.losses import discriminator_loss
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.scripts import time_ms
    from quickvc_tpu_torch.utils.weights import init_random_

    base = init_random_(MultiPeriodDiscriminator(), 3).to(dev)
    fused = MultiPeriodDiscriminator(fused_conv5=True).to(dev)
    fused.load_state_dict(base.state_dict())
    g = torch.Generator(device=dev).manual_seed(4)
    y, y_hat = (0.3 * torch.randn(32, 1, 10240, device=dev, generator=g) for _ in range(2))

    def d_phase(net, dtype=torch.float32):
        logits_r, logits_g, _, _ = net(y.to(dtype), y_hat.to(dtype), pair=True)
        loss = discriminator_loss([z.float() for z in logits_r],
                                  [z.float() for z in logits_g])[0]
        return torch.autograd.grad(loss, list(net.parameters()))

    for name, net in (("D_phase_fused", fused), ("D_phase_default", base)):
        out[name] = time_ms(lambda: d_phase(net), dev, 20, 3)
        out[name + "_bf16"] = time_ms(lambda: d_phase(net, torch.bfloat16), dev, 20, 3)
    # the device time of the fused bf16 phase's K5/K6 launches and their split-K sums
    out["D_phase_fused_bf16_conv5_device_ms"] = sum(
        device_ms(lambda: d_phase(fused, torch.bfloat16), 5, only=name)
        for name in ("conv5", "splitk_sum_bf16"))


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


def cudnn_lstm_layer(w_ih: torch.Tensor, w_hh: torch.Tensor,
                     bias: torch.Tensor) -> torch.nn.LSTM:
    """One layer of cuDNN's LSTM (``nn.LSTM``) in ``w_ih``'s dtype and device
    with these weights, ``bias`` the two biases summed: the LSTM kernels'
    library call. The host takes longer to enqueue a call than the card
    takes to run it, so its events time is the host's and its device time
    the card's."""
    lstm = torch.nn.LSTM(w_ih.shape[1], w_hh.shape[1], 1, batch_first=True,
                         device=w_ih.device, dtype=w_ih.dtype)
    with torch.no_grad():
        for param, w in zip(lstm.parameters(), (w_ih, w_hh, bias, torch.zeros_like(bias))):
            param.copy_(w)
    return lstm


def cudnn_lstm(w_ih, w_hh, biases) -> torch.nn.LSTM:
    """cuDNN's multi-layer LSTM (``nn.LSTM``) with these per-layer weights
    and summed biases, in their dtype and device: the stack's library call."""
    lstm = torch.nn.LSTM(w_ih[0].shape[1], w_hh[0].shape[1], len(w_hh), batch_first=True,
                         device=w_hh[0].device, dtype=w_hh[0].dtype)
    with torch.no_grad():
        for layer, (wi, wh, b) in enumerate(zip(w_ih, w_hh, biases)):
            for name, w in (("weight_ih", wi), ("weight_hh", wh), ("bias_ih", b),
                            ("bias_hh", torch.zeros_like(b))):
                getattr(lstm, f"{name}_l{layer}").copy_(w)
    return lstm


def cudnn_backward(lstm: torch.nn.LSTM, x: torch.Tensor, dh: torch.Tensor):
    """A callable running cuDNN's backward alone of ``lstm`` on input ``x``
    for the output gradient ``dh``: the input and weight gradients, the
    forward's graph built once and kept."""
    x_in = x.detach().clone().requires_grad_()
    out = lstm(x_in)[0]

    def run():
        torch.autograd.grad(out, [x_in, *lstm.parameters()], dh, retain_graph=True)

    return run


def lstm_backward_chain(dh: torch.Tensor, w_ih, w_hh, act: torch.Tensor,
                        c: torch.Tensor) -> list[torch.Tensor]:
    """Every layer's dgates of a bf16 LSTM stack as the port ran them before
    the backward stack kernel: one launch of the one-layer backward kernel a
    layer, top down, the layer below's dh the torch product ``dgates @
    w_ih`` between (``w_ih`` of layers 1 .. L-1, as the stack kernels take
    them)."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    outs, z = [None] * len(w_hh), dh
    for layer in reversed(range(len(w_hh))):
        outs[layer] = lr.lstm_backward_kernel(z, w_hh[layer], act[layer], c[layer])
        if layer:
            z = outs[layer] @ w_ih[layer - 1]
    return outs


def k7_bf16_library(wav: torch.Tensor, w0, gamma, beta, w1):
    """A callable running K7's bf16 library call on a bf16 wave: cuDNN's
    bf16 conv0 -> GroupNorm -> tanh GELU -> conv1 -> tanh GELU, the
    parameters cast to bf16 once."""
    import torch.nn.functional as F

    c = w1.shape[0]
    w0b, w1b, gb, bb = (z.to(torch.bfloat16) for z in (w0, w1, gamma, beta))

    def run():
        y = F.gelu(F.group_norm(F.conv1d(wav[:, None], w0b, stride=5), c, gb, bb, 1e-5),
                   approximate="tanh")
        return F.gelu(F.conv1d(y, w1b, stride=2), approximate="tanh").transpose(1, 2)

    return run


def in_turns(ms, name: str, kernel, library) -> None:
    """``kernel`` and ``library`` timed in turns: library, kernel, kernel,
    library (``name`` + ``_library_a``, ``_a``, ``_b``, ``_library_b``)."""
    for tag, fn in (("_library_a", library), ("_a", kernel), ("_b", kernel),
                    ("_library_b", library)):
        ms(name + tag, fn)


# (batch, heads, T, D) of the bf16 attention's calls: K2 at the conversion,
# the live wave windows and a ragged T; K9; K10 and its small head dim; K8's
ATTENTION_BF16_SHAPES = {"K2": (8, 12, 250, 64), "K2_live68": (64, 12, 68, 64),
                         "K2_live80": (64, 12, 80, 64), "K2_ragged": (3, 12, 333, 64),
                         "K9": (8, 12, 250, 128), "K10": (8, 12, 250, 64),
                         "K10_d16": (2, 3, 50, 16), "K8": (16, 12, 300, 64)}


def attention_bf16_plans(dev: torch.device) -> dict:
    """Each shape's plan for both bf16 bodies (the TMA + wgmma one where the
    head dim takes it), with the body's CTAs an SM, registers and shared
    memory on the card, and the waves of CTAs those give."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, (b, h, t, d) in ATTENTION_BF16_SHAPES.items():
        out[name] = {}
        for tma in (True, False):
            plan = fa.bf16_attention_plan(b, h, t, d, sms, tma)
            occ = fa.attention_bf16_occupancy(d, plan)
            out[name][plan.body] = plan._asdict() | occ | {
                "waves_on_card": -(-plan.ctas // (max(occ["ctas_per_sm"], 1) * sms))}
    return out


def attention_bf16_times(ms, out: dict, dev: torch.device, g: torch.Generator) -> None:
    """K2, K10 and K9's bf16 modes in turns with bf16 SDPA, and the plans."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_attention as fa

    q, k, v = torch.randn(8, 250, 3 * 768, device=dev, generator=g).bfloat16().chunk(3, -1)
    heads = [z.reshape(8, 250, 12, 64).transpose(1, 2).contiguous() for z in (q, k, v)]
    xs = [F.pad(z.reshape(8, 250, 12, 64), (0, 64)).reshape(8, 250, 1536) for z in (q, k, v)]
    padded = [z.reshape(8, 250, 12, 128).transpose(1, 2) for z in xs]
    in_turns(ms, "K2_bf16", lambda: fa.attention_packed(q, k, v, 12, 0.125),
             lambda: F.scaled_dot_product_attention(*heads, scale=0.125))
    in_turns(ms, "K10_bf16", lambda: fa.attention(*heads, 0.125),
             lambda: F.scaled_dot_product_attention(*heads, scale=0.125))
    in_turns(ms, "K9_bf16", lambda: fa.attention_packed_aligned(*xs, 12, 0.125),
             lambda: F.scaled_dot_product_attention(*padded, scale=0.125))
    if hasattr(fa, "bf16_attention_plan"):
        out["attention_bf16_plans"] = attention_bf16_plans(dev)


def bf16_turn_times(ms, out: dict, dev: torch.device, g: torch.Generator, layer, x) -> None:
    """K8's bf16 mode and the LSTM recurrence kernels, each in turns with its
    library call (see the head note), and K8 bf16's device time by kernel."""
    from quickvc_tpu_torch.ops import fused_transformer as ft
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    def turns(name: str, kernel, library) -> None:
        in_turns(ms, name, kernel, library)

    bf = torch.bfloat16
    xb = x.to(bf)
    lib_layer = torch.nn.TransformerEncoderLayer(768, 12, 3072, dropout=0.0, activation="gelu",
                                                 batch_first=True).to(dev).eval()
    lib_layer.load_state_dict(layer.state_dict())
    lib_layer = lib_layer.requires_grad_(False).to(bf)

    def k8_library():
        with torch.inference_mode():
            return lib_layer(xb)

    turns("K8_bf16", lambda: ft.transformer_layer(xb, layer), k8_library)
    out["K8_bf16_kernels"] = device_breakdown(lambda: ft.transformer_layer(xb, layer), 50)

    b, t_len, hsz = 32, 512, 256
    mel = torch.randn(b, t_len, 80, device=dev, generator=g).to(bf)
    w_ih = (torch.randn(4 * hsz, 80, device=dev, generator=g) / 16).to(bf)
    w_hh = (torch.randn(4 * hsz, hsz, device=dev, generator=g) / 16).to(bf)
    bias = (torch.randn(4 * hsz, device=dev, generator=g) / 16).to(bf)
    xp = mel @ w_ih.T + bias
    dh = torch.randn(b, t_len, hsz, device=dev, generator=g).to(bf)
    _, act, c = lr.lstm_forward_kernel(xp, w_hh)
    x_in = mel.requires_grad_()
    cudnn = cudnn_lstm_layer(w_ih, w_hh, bias)

    turns("lstm_bf16", lambda: lr.lstm_forward_kernel(xp, w_hh), lambda: cudnn(x_in)[0])
    out["lstm_bf16_host_us"] = host_us({"kernel": lambda: lr.lstm_forward_kernel(xp, w_hh),
                                        "library": lambda: cudnn(x_in)[0]}, 10)
    def cudnn_step():
        torch.autograd.grad(cudnn(x_in)[0], [x_in, *cudnn.parameters()], dh)

    def kernel_step():
        _, act_, c_ = lr.lstm_forward_kernel(xp, w_hh)
        lr.lstm_backward_kernel(dh, w_hh, act_, c_)

    turns("lstm_bf16_backward", lambda: lr.lstm_backward_kernel(dh, w_hh, act, c), cudnn_step)
    turns("lstm_bf16_layer_step", kernel_step, cudnn_step)

    # the three-layer forward from the mel, layer 0's projection included
    w_ih = [w_ih] + [(torch.randn(4 * hsz, hsz, device=dev, generator=g) / 16).to(bf)
                     for _ in range(2)]
    w_hhs = [w_hh] + [(torch.randn(4 * hsz, hsz, device=dev, generator=g) / 16).to(bf)
                      for _ in range(2)]
    biases = [bias] + [(torch.randn(4 * hsz, device=dev, generator=g) / 16).to(bf)
                       for _ in range(2)]
    cudnn3 = cudnn_lstm(w_ih, w_hhs, biases)
    mel_in = mel.detach()

    def layers_forward():
        z = mel_in
        for wi, wh, bb in zip(w_ih, w_hhs, biases):
            z = lr.lstm_forward_kernel(z @ wi.T + bb, wh)[0]
        return z

    with torch.no_grad():
        turns("lstm_layers_bf16", layers_forward, lambda: cudnn3(mel_in)[0])
        if hasattr(lr, "lstm_stack_kernel"):
            turns("lstm_stack_bf16", lambda: lr.lstm_stack_kernel(
                mel_in @ w_ih[0].T + biases[0], w_ih[1:], biases[1:], w_hhs),
                lambda: cudnn3(mel_in)[0])


def lstm_backward_turns(ms, out: dict, dev: torch.device, g: torch.Generator) -> None:
    """The speaker LSTM's three-layer bf16 backward at the training batch
    (32, 512, 4 x 256), in turns with cuDNN's 3-layer bf16 backward alone
    (the forward's graph kept; ``cudnn_backward``): ``lstm_backward`` is the
    package's own path, one launch of the backward stack kernel where the
    package has it, else ``lstm_backward_chain``, the three layers one
    launch each with the torch product between (the parent's schedule)."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    bf, b, t_len, hsz, layers = torch.bfloat16, 32, 512, 256, 3
    mel = torch.randn(b, t_len, 80, device=dev, generator=g).to(bf)
    w_ih = [(torch.randn(4 * hsz, 80 if i == 0 else hsz, device=dev, generator=g) / 16).to(bf)
            for i in range(layers)]
    w_hh = [(torch.randn(4 * hsz, hsz, device=dev, generator=g) / 16).to(bf)
            for _ in range(layers)]
    biases = [(torch.randn(4 * hsz, device=dev, generator=g) / 16).to(bf) for _ in range(layers)]
    dh = torch.randn(b, t_len, hsz, device=dev, generator=g).to(bf)
    with torch.no_grad():
        _, act, c = lr.lstm_stack_kernel(mel @ w_ih[0].T + biases[0], w_ih[1:], biases[1:], w_hh)

    def chain():
        lstm_backward_chain(dh, w_ih[1:], w_hh, act, c)

    def stack():
        lr.lstm_stack_backward_kernel(dh, w_ih[1:], w_hh, act, c)

    own = stack if hasattr(lr, "lstm_stack_backward_kernel") else chain
    out["lstm_backward_path"] = own.__name__
    with torch.no_grad():
        in_turns(ms, "lstm_backward", own, chain)
    in_turns(ms, "lstm_backward_cudnn3", own,
             cudnn_backward(cudnn_lstm(w_ih, w_hh, biases), mel, dh))


def extractor_bf16_turns(ms, out: dict, dev: torch.device, g: torch.Generator) -> None:
    """K7's bf16 mode at the encoding batch's bf16 wave (16, 96080) ->
    (16, 9607, 512) in turns with cuDNN's bf16 chain (``k7_bf16_library``:
    ``K7_bf16_library``); ``K7_bf16_body`` names the body the package's
    route ran (its ``wgmma`` body's counter, where it has one)."""
    from quickvc_tpu_torch.ops import fused_extractor as fe

    c = 512
    wav = (0.3 * torch.randn(16, 96080, device=dev, generator=g)).to(torch.bfloat16)
    w0 = 0.3 * torch.randn(c, 1, 10, device=dev, generator=g)
    gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
    beta = 0.1 * torch.randn(c, device=dev, generator=g)
    w1 = torch.randn(c, c, 3, device=dev, generator=g) / (3 * c) ** 0.5
    front = (wav, w0, gamma, beta, w1)
    stats = getattr(fe, "WGMMA_STATS", None)
    before = stats.launches if stats else 0
    fe.extractor_front(*front)
    out["K7_bf16_body"] = "wgmma" if stats and stats.launches > before else "mma_sync"
    with torch.no_grad():
        in_turns(ms, "K7_bf16", lambda: fe.extractor_front(*front), k7_bf16_library(*front))


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
    device = device_ms(run, calls)   # the profiler has read no kernel at all at times
    return {"events": flops / (time_ms(run, dev, calls, 2) * 1e-3) / 1e12,
            "device": flops / (device * 1e-3) / 1e12 if device > 0 else None}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="checkout to import quickvc_tpu_torch from")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--only", choices=("bf16", "conv5", "lstm", "extractor"), default=None,
                    help="bf16: only the bf16 attention, K8 bf16 and LSTM turns; conv5: only "
                         "K5/K6 bf16's turns, their plans' sweep and the D phases; lstm: only "
                         "the three-layer LSTM backward's turns; extractor: only K7 bf16's "
                         "(on the card)")
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

    if args.only and dev.type != "cuda":
        raise SystemExit(f"kernel_times: --only {args.only} times kernels on the card")
    if args.only == "conv5":
        conv5_times(ms, dev, g, out, bf16_only=True, shapes=CONV5_SHAPES | {7: (448, 19, 1024)})
        disc_phase_times(out, dev)
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print("kernel_times " + json.dumps(out))
        return out
    if args.only in ("lstm", "extractor"):
        (lstm_backward_turns if args.only == "lstm" else extractor_bf16_turns)(ms, out, dev, g)
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print("kernel_times " + json.dumps(out))
        return out
    if args.only == "bf16":
        layer = init_random_(TransformerLayer(use_fused_layer=True), 8).to(dev).eval()
        layer.requires_grad_(False)
        x = torch.randn(16, 300, 768, device=dev, generator=g)
        attention_bf16_times(ms, out, dev, g)
        bf16_turn_times(ms, out, dev, g, layer, x)
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print("kernel_times " + json.dumps(out))
        return out
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
        attention_bf16_times(ms, out, dev, g)
        bf16_turn_times(ms, out, dev, g, layer, x)
        out["notes"] = gemm_times(ms, dev, g)
        conv5_times(ms, dev, g, out)
        out["mma_sync_tf32_tflops"] = mma_tf32_tflops(dev, args.iters)
        disc_phase_times(out, dev)
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print("kernel_times " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
