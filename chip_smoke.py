#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``quickvc_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``quickvc_tpu_torch/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and times kernel, plain version and one
   PyTorch library call for the same function (CUDA events, after warm-up;
   K1-K4 and K9-K11 also in profiler device time, ``device_ms``):
   K1-K3 at the conversion's shapes (K1 on its real-FFT route, also held
   at n_fft/hop 2048/512 on it and at 800/200 and 4096/1024 on its dense
   DFT, one bin chunk and three, and timed in turns with the torch.stft
   chain; K3 also at 32/8, its table-driven body, timed in turns with its
   ``torch.istft`` chain, in device time also at the streaming and live
   windows and with the L2 flushed between launches, two launches
   bit-equal), K4 at the full
   training batch (32, 512*320+960) (also held at n_fft/hop 1024/256 on its
   real FFT and at 800/200 on its dense DFT, whose time it prints), K5 (forward and
   dx) and K6 (dW) at the fifth conv of each period discriminator in the
   paired D phase, x (64 p, R_p, 1024) for p in 2, 3, 5, 7, 11 (timed against
   cuDNN at p = 2 and 11, the bound the 3xTF32 one; two launches bit-equal), K7
   (HuBERT's extractor front) at the encoding batch's wave (16, 96080) and
   K8 (a whole HuBERT layer) at its hidden state (16, 300, 768) and, split-K,
   at (1, 300, 768) (each timed in turns with its cuDNN chain or the library
   layer, the bound the 3xTF32 one; two launches bit-equal). K2 and K3 are also held against their plain
   versions at the streaming and live paths' shapes: K2 over the streaming
   run's buckets (8, 650 / 800, 768) and the live wave windows (64, 80 / 68,
   768), K3 over the streaming windows (32, 5761, 9), the live windows
   of 64 streams (256, 1601 / 1361, 9) and of one (4, 1361, 9) and the
   parity session's (8, 4161, 9). K2, K9 and
   K10 (the 3xTF32 tensor-core attention body) are timed in turns with
   ``F.scaled_dot_product_attention`` on the same inputs, their bound the
   3xTF32 one, with the float32-FMA bound beside it on their
   ``kernel_check`` lines (``bound_f32_fma_ms``). K2's bf16 mode (bf16
   ``mma.sync``) is held against its plain version on the same bf16 inputs
   at (8, 250, 768), the live wave windows of 64 streams and a ragged (3,
   333, 768) (max |diff| <= 8e-3 max|v|, its error against float64
   attention at most 1.5x the plain version's) and timed in turns with bf16
   SDPA, its bound the bytes. The bf16 modes of K7 (at the encoding batch),
   K8 (at (16, 300, 768) and, split-K, (1, 300, 768)), K9 and K10 (at the
   attention layouts' shapes) are held against their plain versions on the
   same bf16 inputs (max |diff| <= 1e-2 max|plain| or two bf16 ulps of it,
   and each kernel's error against its float32 kernel on the bf16-valued
   inputs at most 1.5x the plain version's) and timed in turns with cuDNN's
   bf16 chain, ``nn.TransformerEncoderLayer`` in bf16 and bf16 SDPA. So are
   the bf16 modes of K5 (forward, dx) and K6 (dW) at the five period shapes
   in bf16, on their TMA + ``wgmma`` body (``csrc/conv5_wgmma.cu``), and at
   two shapes whose channels are not multiples of 8, on the ``mma.sync``
   body (two launches bit-equal, each shape on its body by the counters; at
   p = 2 and 11 timed in turns with the ``mma.sync`` body on the same inputs
   and with cuDNN's bf16 conv, its input and its weight gradient, beside
   each call's plan and the body's registers, spills and blocks an SM).
   K8's bf16 mode runs its GEMMs on the persistent TMA + ``wgmma`` core
   (``csrc/wgmma_bf16.cuh``). The bf16
   attention of K2, K8, K9 and K10 runs the TMA + ``wgmma`` body at head
   dims 64 and 128 (the ``mma.sync`` body at 16 and 32): an
   ``attention_bf16_plans`` line gives, for each path shape, both bodies'
   plans (CTA rows, key tile, stages, CTAs and waves) with each body's
   registers and CTAs an SM on the card, and the K2, K9 and K10 bf16 rows
   their plans and two launches bit-equal.
3. Drives the conversion path, the CLI ``quickvc_tpu_torch.convert`` with
   ``--device cuda --batch 8``, at the full width of ``configs/quickvc.json``
   plus the full HuBERT-soft, with seeded random weights, on seeded
   synthetic wavs; checks the outputs and that K1-K3 were launched (K1 on
   its FFT route), with the launch counters zeroed just before; repeats the
   conversion for the
   throughput; converts once more under torch.profiler for the device time
   by kernel and the device's busy share of the conversion loop.
4. Checks the conversion path on the card against the CPU plain path on a
   small input (noise 0).
5. Drives the training path, the CLI ``quickvc_tpu_torch.train`` with
   ``--device cuda``, for 7 steps at full width (batch 32, 512-frame crops,
   compact transfer, float32) on a synthetic corpus, with eval after
   updates 1 and 5 on 3 held-out utterances; checks finite losses and eval
   metrics, moved weights, K4 launched once per step and K1 (FFT route) and
   K3 twice a held-out item an eval, nothing else; times steps 3-7 and each
   eval; reads back the TensorBoard event files (every record's CRC-32Cs,
   the loss, step-wall, RSS, eval, image and audio tags); profiles one more
   (resumed) step; holds the eval with the trained ``G_7.pth`` on the card
   against the CPU plain path; compares the batches of the first 2 epochs
   (one each) from thread and process loader workers; converts a pair with
   ``G_7.pth``. Then the same trainer at ``precision: "bf16"`` (units on
   the wire in bf16) for 4 steps with eval after update 1: finite losses,
   K4 once a step, K1 and K3 in the float32 eval, float32 parameters and
   moments in its checkpoints, its step walls and peak memory printed beside
   the float32 run's.
6. Drives the discriminator's opt-in K5/K6 path (``fused_conv5=True``, the
   A/B of ``scripts/disc_pallas_ab.py``): one D-phase forward and backward
   of the full-width MPD at the training batch, held against the default
   cuDNN discriminator; the same on bf16 waves (K5 bf16 10 times, K6 bf16 5
   times, all on the ``wgmma`` body, nothing else of the port; both D
   phases timed) against the default cuDNN bf16 discriminator, relative to
   the default's bf16 error against its float32
   D phase; then the port of that A/B script at its defaults
   (``quickvc_tpu_torch.scripts.disc_pallas_ab``: the fifth conv alone at p
   = 2 and 11, three variants of the period discriminator at p = 2, 5, 11,
   bf16), every line finite, K5/K6 bf16 launched as each variant implies.
7. Checks one training step on the card against the same step on the CPU
   plain path at a small config (same weights, batch and draws), in float32
   and at bf16 (the bf16 step relative to the CPU's bf16 error against its
   float32 step; every parameter float32 after it), and the bf16 speaker
   LSTM at full width on its kernels (the three layers' forward in one
   launch of the stack kernel, the JAX wavefront; their backward in one
   launch of the backward stack kernel, the wavefront reversed) against
   their plain versions on the card: the encoder's d-vectors and
   gradients, the stack's h, act and c and the backward's dgates of every
   layer, the stack timed against cuDNN's 3-layer bf16 ``nn.LSTM``
   forward and the backward stack against the same three layers one
   launch each and cuDNN's 3-layer backward; then both stacks at three
   layers of 640 rows, which the card cannot hold at once, must raise
   RuntimeError and launch nothing; then the bf16 step gate on seeds 1-5.
8. Drives offline unit encoding, the CLI ``quickvc_tpu_torch.encode`` with
   ``--batch 16``, at full width (the conversion's random HuBERT-soft) on 32
   seeded synthetic wavs in two 1-s buckets, three times: the default
   ``faststats`` front, the ``pallas`` front (K7) and the ``pallas`` front
   with every layer fused (K8); checks each run's launches and holds its
   units against the default run's; prints each run's audio seconds per
   wall second and profiles each once more.
9. Checks the encoding of one short file on the card (K7, K8) against the
   CPU plain path.
10. Drives the attention ops API: K10 (``ops.fused_attention.attention``,
    (B, H, T, D)) at the conversion's HuBERT shape (8, 12, 250, 64) and at
    (2, 3, 50, 16), K9 (``attention_packed_aligned``) at (8, 250, 12*128),
    through their public dispatchers, in float32 and again in bf16 (their
    bf16 modes, counted apart); K9 and K10 are also held against their
    plain versions and ``F.scaled_dot_product_attention`` in step 2.
11. Runs the int8 GEMM probe, ``python -m
    quickvc_tpu_torch.scripts.int8_matmul_probe`` (K11 in int8 and bf16 at
    (16384 x 12288) @ (12288 x 3072), its whole int8 output exact, a tile
    sweep, ``torch._int_mm`` and bf16 ``torch.matmul`` beside it); K11 is
    also held against its plain version in step 2, where a bf16 call must
    launch no B^T pre-pass and ``torch.mm(..., out_dtype=torch.float32)``
    is timed beside it where this torch has it.
12. Drives streaming conversion, the CLI with ``--streaming --chunk-frames 96
    --context-frames 96 --batch 8 --noise-scale 0``, and the same without
    ``--streaming``, on 16 synthetic sources of 12.1-15.5 s that fill two
    batches of 8 (the 13-s and 16-s buckets): launch counts, interiors (200
    frames trimmed at each edge) within 1e-3 x peak, audio s per wall s of
    both; profiles the streaming run once more.
13. Drives the live sessions through ``quickvc_tpu_torch.scripts.
    realtime_bench.main`` (units and wave, N in {1, 8, 64} at chunk 16, left
    48, right 16; N in {1, 64} at chunk 4, left 60, right 4): step time, rtf,
    latency and launches per tick; profiles 5 unit ticks at N = 1 and 5
    wave ticks at N = 64; then a full-width unit session (N = 2, chunk 16,
    left and right 96, noise 0) over a 12-s unit stream and its flush
    against batch ``infer`` of the same units. The benchmark runs with
    ``--precision f32`` and again with ``--precision bf16`` (K2's bf16 mode
    12 times a wave tick), the step times printed side by side.
14. Checks one streaming batch (HuBERT units of two 4-s sources, then
    ``streaming_infer``) and three ticks of a full-width wave session (N =
    2, chunk 16, left 48, right 16) on the card against the CPU plain path
    (noise 0, 1e-3 x peak); then three ticks of the same session at bf16
    (K2 bf16, K3) against the CPU's bf16 session, relative to its bf16
    error against its float32 one; and three ticks of the bf16 session with
    a HuBERT running the ``pallas`` front and fused layers (K7 bf16 once and
    K8 bf16 12 times a tick, K3), against the CPU's the same way, then at
    N = 64 its step time over 5 ticks in turns with the ``faststats`` one.

Prints one JSON line per check, the card's name and power limit, the status
of every TPU kernel of the JAX package, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
Without a CUDA card, or outside a checkout of the repo, it exits non-zero
and prints no result. Imports nothing of JAX or ``quickvc_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
SR = 16000
# sources in two 1-s buckets (5 s and 6 s), 8 to a batch; three unique targets
SOURCE_SECONDS = [4.2 + 0.1 * i for i in range(8)] + [5.1 + 0.1 * i for i in range(8)]
TARGET_SECONDS = [3.0, 6.5, 9.0]
TARGET_SR = 22050
BATCH = 8
REPEATS = 5  # measured conversions: the first counts launches, all give throughput
# H100 SXM peaks (NVIDIA data sheet): float32 FMA rate, dense TF32, int8 and
# bf16 tensor-core rates, HBM rate
F32_FLOPS = 67e12
TF32_FLOPS = 495e12   # a float32-accurate product takes three TF32 products (3xTF32)
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12

TPU_KERNELS = [
    ("K1", "quickvc_tpu/ops/fused_mel.py:227", "wave_to_mel_pallas",
     "ported: quickvc_tpu_torch/csrc/fused_mel.cu; redesigned: K4's real FFT (FFT_SIZES), "
     "dense DFT up to n_fft 4096"),
    ("K2", "quickvc_tpu/ops/fused_attention.py:113", "fused_attention_packed",
     "ported: quickvc_tpu_torch/csrc/fused_attention.cu; redesigned: 3xTF32 tensor cores; "
     "bf16 mode: quickvc_tpu_torch/csrc/fused_attention_bf16.cuh (bf16 mma.sync, float32 "
     "softmax and accumulation), redesigned: TMA + wgmma body, planned grid (mma.sync at "
     "D 16/32 and on views TMA does not take)"),
    ("K3", "quickvc_tpu/ops/fused_istft.py:159", "polar_inverse_stft_pallas",
     "ported: quickvc_tpu_torch/csrc/fused_istft.cu; the JAX head's sizes, n_fft up to 2048; "
     "redesigned: persistent planned grid, host-built tables, loads one step ahead"),
    ("K4", "quickvc_tpu/ops/fused_mel.py:177", "wave_to_spec_halo_pallas",
     "ported: quickvc_tpu_torch/csrc/fused_mel.cu; redesigned: real FFT (FFT_SIZES), "
     "dense DFT up to n_fft 4096"),
    ("K5", "quickvc_tpu/ops/fused_disc_conv.py:117", "conv5_lrelu forward (and dx)",
     "ported: quickvc_tpu_torch/csrc/fused_disc_conv.cu; redesigned: 3xTF32 tensor cores; "
     "bf16 mode: quickvc_tpu_torch/csrc/conv5_wgmma.cu (persistent TMA + wgmma), the bf16 "
     "mma.sync body of fused_disc_conv.cu for other channel counts"),
    ("K6", "quickvc_tpu/ops/fused_disc_conv.py:156", "conv5_lrelu dW",
     "ported: quickvc_tpu_torch/csrc/fused_disc_conv.cu; redesigned: 3xTF32 tensor cores, "
     "deterministic split-K; bf16 mode: quickvc_tpu_torch/csrc/conv5_wgmma.cu (persistent "
     "TMA + wgmma, planned split-K rounded once), the bf16 mma.sync body for other shapes"),
    ("K7", "quickvc_tpu/ops/fused_extractor.py:187", "fused_extractor_front",
     "ported: quickvc_tpu_torch/csrc/fused_extractor.cu; redesigned: 3xTF32 tensor-core "
     "implicit GEMM, conv0 produced on chip; bf16 mode: same file, on the bf16 mma.sync "
     "core of quickvc_tpu_torch/csrc/bf16_gemm.cuh"),
    ("K8", "quickvc_tpu/ops/fused_transformer.py:155", "fused_transformer_layer",
     "ported: quickvc_tpu_torch/csrc/fused_transformer.cu; redesigned: GEMMs and attention "
     "on 3xTF32 tensor cores; bf16 mode: same file, GEMMs on the persistent TMA + wgmma "
     "core of quickvc_tpu_torch/csrc/wgmma_bf16.cuh, K2's bf16 attention body (TMA + "
     "wgmma)"),
    ("K9", "quickvc_tpu/ops/fused_attention.py:194", "fused_attention_packed_aligned",
     "ported: quickvc_tpu_torch/csrc/fused_attention.cu; redesigned: 3xTF32 tensor cores; "
     "bf16 mode: quickvc_tpu_torch/csrc/fused_attention_bf16.cuh at D = 128, redesigned: "
     "TMA + wgmma body"),
    ("K10", "quickvc_tpu/ops/fused_attention.py:231", "fused_attention",
     "ported: quickvc_tpu_torch/csrc/fused_attention.cu; redesigned: 3xTF32 tensor cores; "
     "bf16 mode: quickvc_tpu_torch/csrc/fused_attention_bf16.cuh, redesigned: TMA + wgmma "
     "body at D 64/128"),
    ("K11", "scripts/int8_matmul_probe.py:85", "pallas_mm",
     "ported: quickvc_tpu_torch/csrc/int8_mm.cu; redesigned: persistent TMA + wgmma, bf16 "
     "without a B^T pre-pass"),
]
# training path: full width, batch 32, 512-frame crops (utterances of 12.5-13.5 s
# fall in the (600, 700]-frame bucket, cropped to max_speclen 512)
TRAIN_STEPS = 7
TRAIN_WARMUP = 2
BF16_TRAIN_STEPS = 4   # the same trainer at precision bf16: eval after update 1 only
# eval after updates 1 and 5 (the JAX loop's points at eval_interval 4) on three
# held-out utterances that are not whole seconds, so the 1-s buckets reflect-pad
EVAL_INTERVAL = 4
EVAL_SECONDS = [3.3, 4.6, 5.2]
EVALS = len(range(0, TRAIN_STEPS, EVAL_INTERVAL))
LOADER_CHECK_EPOCHS = (1, 2)   # one full-width batch each: thread against process workers
TRAIN_UTTERANCES = 32
TRAIN_BATCH = 32
DISC_BATCH = 2 * TRAIN_BATCH        # the D phase runs real||fake paired
SEGMENT = 10240
# offline encoding: 32 files, 16 in the 5-s bucket and 16 in the 6-s one, 16 to a batch
ENCODE_SECONDS = [4.2 + 0.05 * i for i in range(16)] + [5.2 + 0.05 * i for i in range(16)]
ENCODE_BATCH = 16
ENCODE_RUNS = (("faststats", "faststats", False), ("pallas", "pallas", False),
               ("pallas_fused_layer", "pallas", True))   # (name, --hubert-front, fused_layer)
# the port's __global__ functions, as the profiler names them
DEVICE_FUNCTIONS = ("wave_to_mel_kernel", "wave_to_mel_fft_kernel", "attention_kernel",
                    "attention_bf16_kernel", "attention_wgmma_kernel",
                    "polar_istft_kernel",
                    "wave_to_spec_halo_kernel", "conv5_gemm_kernel", "splitk_sum_kernel",
                    "extractor_front_kernel", "linear_kernel", "linear_splitk_kernel",
                    "row_layer_norm_kernel", "extractor_front_bf16_kernel",
                    "linear_wgmma_kernel", "linear_bf16_splitk_kernel",
                    "conv5_bf16_kernel", "splitk_sum_bf16_kernel", "conv5_wgmma_kernel",
                    "mm_wgmma_kernel", "transpose_kernel", "lstm_stack_kernel",
                    "lstm_stack_backward_kernel", "extractor_front_wgmma_kernel")
# the entry functions whose ptxas registers and spills the build step prints
# (K4's both routes, K1's FFT route, K11's bodies, the attention body of
# K2/K8/K9/K10 and K2's two bf16 bodies, K5/K6's implicit GEMM and K6's
# split-K sum, K7, K8's GEMMs and their split-K sum, K3's both bodies, the
# bf16 modes of K7 (both bodies), K8's GEMMs (the wgmma core) and K5/K6
# (both bodies) with K6's bf16 split-K sum, and the LSTM recurrence's two
# stack kernels); none may spill
PTXAS_WATCH = ("wave_to_spec_halo_kernel", "wave_to_mel_fft_kernel", "mm_wgmma_kernel",
               "transpose_kernel", "attention_kernel", "attention_bf16_kernel",
               "attention_wgmma_kernel",
               "conv5_gemm_kernel", "splitk_sum_kernel",
               "extractor_front_kernel", "linear_kernel", "linear_splitk_kernel",
               "extractor_front_bf16_kernel", "linear_wgmma_kernel",
               "linear_bf16_splitk_kernel", "polar_istft_kernel", "polar_istft_kernel_rt",
               "conv5_bf16_kernel", "splitk_sum_bf16_kernel", "conv5_wgmma_kernel",
               "lstm_stack_kernel", "lstm_stack_backward_kernel",
               "extractor_front_wgmma_kernel")
REDESIGNED = {"wave_to_mel": "redesigned: real FFT",
              "wave_to_spec_halo": "redesigned: real FFT",
              "mm_s8": "redesigned: persistent TMA + wgmma",
              "mm_bf16": "redesigned: persistent TMA + wgmma, B read MN-major (no pre-pass)",
              "attention_packed": "redesigned: 3xTF32 tensor cores",
              "attention_packed_bf16": "redesigned: TMA + wgmma body (K/V ring, P in "
                                       "registers), grid planned to whole waves; mma.sync "
                                       "body at D 16/32 and unaligned views",
              "attention_packed_aligned": "redesigned: 3xTF32 tensor cores",
              "attention": "redesigned: 3xTF32 tensor cores",
              "conv5_lrelu": "redesigned: 3xTF32 tensor-core implicit GEMM",
              "conv5_lrelu_dw": "redesigned: 3xTF32 tensor-core implicit GEMM, split-K",
              "extractor_front": "redesigned: 3xTF32 tensor-core implicit GEMM, conv0 "
                                 "produced on chip",
              "transformer_layer": "redesigned: GEMMs on 3xTF32 tensor cores, planned split-K",
              "extractor_front_bf16": "redesigned: persistent warp-specialised TMA + wgmma "
                                      "body at C = 512 (a producer warpgroup makes h beside "
                                      "the wgmma consumers, conv1's weight multicast to a "
                                      "2-CTA cluster); the bf16 mma.sync body at other widths",
              "transformer_layer_bf16": "redesigned: GEMMs on the persistent TMA + wgmma bf16 "
                                        "core, K2's bf16 attention body (TMA + wgmma)",
              "lstm_stack_bf16": "new: replaces no TPU kernel (the JAX package's lax.scan); "
                                 "redesigned: every layer in one launch, the JAX wavefront",
              "lstm_stack_bf16_backward": "new: replaces no TPU kernel (the lax.scan's "
                                          "transpose); redesigned: every layer in one launch, "
                                          "the reverse wavefront",
              "attention_packed_aligned_bf16": "redesigned: K2's TMA + wgmma bf16 body at "
                                               "D = 128",
              "attention_bf16": "redesigned: K2's TMA + wgmma bf16 body on (B, H, T, D)",
              "conv5_lrelu_bf16": "redesigned: persistent TMA + wgmma implicit GEMM, shifted "
                                  "TMA boxes with the item-edge rows zeroed on chip; the "
                                  "bf16 mma.sync body for other channel counts and views",
              "conv5_lrelu_dw_bf16": "redesigned: persistent TMA + wgmma implicit GEMM, A read "
                                     "MN-major, planned split-K rounded once; the bf16 "
                                     "mma.sync body for other channel counts and views",
              "polar_inverse_stft": "redesigned: persistent planned grid, host-built tables, "
                                    "loads one step ahead"}
# streaming conversion: 16 sources of 12.1-15.5 s (605-773 frames), 8 in the 13-s
# bucket and 8 in the 16-s one, so each batch of 8 is full
STREAM_SECONDS = [12.1 + 0.1 * i for i in range(8)] + [15.05 + 0.06 * i for i in range(8)]
STREAM_CHUNK, STREAM_CONTEXT = 96, 96
EDGE_FRAMES = 200     # trimmed at each edge before streaming and batch output are compared
# live sessions: the realtime benchmark up to 64 streams, then a parity session
LIVE_STREAMS = 64
LIVE_ARGS = ["--device", "cuda", "--iters", "10", "--max-streams", str(LIVE_STREAMS),
             "--precision", "f32"]
LIVE_ARGS_BF16 = LIVE_ARGS[:-1] + ["bf16"]
PARITY_FRAMES, PARITY_CHUNK, PARITY_CONTEXT = 600, 16, 96
# the bf16 modes of K7-K10 against their plain versions (PERF.md section 2):
# max|kernel - plain| <= BF16_GATE max|plain| (or two bf16 ulps of it), and
# the kernel's error against the float32 kernel on the same bf16-valued
# inputs <= BF16_F32_RATIO times the plain version's
BF16_GATE, BF16_F32_RATIO = 1e-2, 1.5
# the bf16 wave session with the `pallas` front and fused layers: launches a tick
PALLAS_BF16_TICK = {"extractor_front_bf16": 1, "extractor_front_bf16_wgmma": 1,
                    "transformer_layer_bf16": 12, "polar_inverse_stft": 1}
LIVE_SPAN = "quickvc_live_ticks"   # profiled span of a few live-session ticks


class CheckFailed(Exception):
    """A check of the smoke run failed; the run exits non-zero."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (the port's CUDA-event timer)."""
    from quickvc_tpu_torch.scripts import time_ms

    return time_ms(fn, torch.device("cuda"), iters, warmup)


def device_ms(fn, iters: int = 20, between=None, only: str | None = None) -> float:
    """Mean device milliseconds per call (profiler device time of the kernels
    the calls launch, ``scripts/kernel_times.py:device_ms``; ``between`` runs
    before each call, ``only`` keeps the kernels whose names hold it). A
    kernel of tens of microseconds needs it: CUDA events around its calls
    also read how fast the host enqueues them."""
    from quickvc_tpu_torch.scripts.kernel_times import device_ms as profiled_ms

    return profiled_ms(fn, iters, between, only)


def turns(kernel, library, iters: int = 20) -> dict:
    """The kernel and its library call timed in turns (library, kernel,
    kernel, library): ``ms`` and ``library_ms`` are the means of each pair,
    ``ms_turns`` and ``library_ms_turns`` the four readings in order;
    ``device_ms`` and ``library_device_ms`` the same turns in device time."""
    lib0, k0, k1, lib1 = (cuda_ms(f, iters) for f in (library, kernel, kernel, library))
    dl0, dk0, dk1, dl1 = (device_ms(f, iters) for f in (library, kernel, kernel, library))
    return {"ms": (k0 + k1) / 2, "library_ms": (lib0 + lib1) / 2,
            "ms_turns": [k0, k1], "library_ms_turns": [lib0, lib1],
            "device_ms": (dk0 + dk1) / 2, "library_device_ms": (dl0 + dl1) / 2}


def ptxas_report(build_log: str) -> dict:
    """Registers and spill bytes of each entry function in ``PTXAS_WATCH``
    from nvcc's ``-Xptxas -v`` log (mangled names shortened to the match)."""
    out, entry = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            continue
        if "Function properties for" in line:
            entry = line.split("Function properties for")[1].strip()
            continue
        name = max((w for w in PTXAS_WATCH if entry and w in entry), key=len, default=None)
        if name is None:
            continue
        rec = out.setdefault(entry, {"kernel": name})
        if "spill stores" in line:
            nums = [int(x) for x in line.replace(",", " ").split() if x.isdigit()]
            rec["stack_bytes"], rec["spill_store_bytes"], rec["spill_load_bytes"] = nums[:3]
        elif "Used" in line and "registers" in line:
            rec["registers"] = int(line.split("Used")[1].split()[0])
    return out


def attention_bounds(flops: float, nbytes: float) -> dict:
    """Bounds of the 3xTF32 attention body: three TF32 products for each
    float32-accurate one, or the bytes; the float32 FMA figure beside them."""
    return {"bound_ops_ms": 3 * flops / TF32_FLOPS * 1e3,
            "bound_bytes_ms": nbytes / HBM_BYTES * 1e3,
            "bound_f32_fma_ms": flops / F32_FLOPS * 1e3}


def compare(ours: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> dict:
    diff = (ours - ref).abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / ref.abs().clamp(min=1e-12)).max()),
            "within_tol": bool((diff <= atol + rtol * ref.abs()).all()),
            "atol": atol, "rtol": rtol}


def merge_checks(checks: dict) -> dict:
    """One row's error keys over several compared shapes (``compare`` dicts
    of one tolerance): the largest errors, within tolerance only if all are."""
    first = next(iter(checks.values()))
    return {"checks": checks, "atol": first["atol"], "rtol": first["rtol"],
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
            "max_rel_err": max(c["max_rel_err"] for c in checks.values()),
            "within_tol": all(c["within_tol"] for c in checks.values())}


def path_shapes() -> dict:
    """Shapes K2 and K3 take on the streaming and live paths: the streaming
    run's HuBERT frames per bucket and window frames, the live benchmark's
    window frames (at up to LIVE_STREAMS streams) and the parity session's."""
    from quickvc_tpu_torch.scripts import realtime_bench

    return {"stream_frames": sorted({int(np.ceil(s)) * SR // 320 for s in STREAM_SECONDS}),
            "stream_window": STREAM_CHUNK + 2 * STREAM_CONTEXT,
            "live_windows": sorted({c + left + right for _, n, c, left, right
                                    in realtime_bench.POINTS if n <= LIVE_STREAMS}),
            "parity_window": PARITY_CHUNK + 2 * PARITY_CONTEXT}


def synth_voice(seconds: float, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Seeded voiced-speech-like signal: harmonics of a wandering f0 under
    syllable-rate envelopes, plus breath noise, with silent lead-in/out."""
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    f0 = rng.uniform(90, 220) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * tt))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 12))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * tt) + 0.3, 0, None)
    x = x * env + 0.02 * rng.standard_normal(n)
    lead = int(0.2 * sr)
    x[:lead] *= 1e-3
    x[-lead:] *= 1e-3
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions


def check_kernels(dev: torch.device, rng: np.random.Generator) -> list[dict]:
    import torch.nn.functional as F

    from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as istft_plain
    from quickvc_tpu_torch.dsp.mel import mel_filterbank
    from quickvc_tpu_torch.dsp.stft import hann_window, wave_to_mel as mel_plain
    from quickvc_tpu_torch.ops import fused_attention, fused_istft, fused_mel
    from quickvc_tpu_torch.scripts.kernel_times import l2_flush

    results = []
    shapes = path_shapes()

    # K1 at the longest target's bucket: (1, 9 s) -> (1, 450, 80), on its FFT
    # route; held against the plain version there and at 2048/512 (FFT),
    # 800/200 (dense, one bin chunk) and 4096/1024 (dense, three chunks)
    t_len = int(np.ceil(max(TARGET_SECONDS))) * SR
    y = torch.from_numpy(synth_voice(t_len / SR, SR, rng)[None]).to(dev)
    win = torch.as_tensor(hann_window(1280), device=dev)

    def k1_at(n_fft: int, hop: int):
        return fused_mel.wave_to_mel_kernel(y, SR, n_fft, hop, n_fft, 80)

    k1_checks = {}
    for n_fft, hop in ((1280, 320), (2048, 512), (800, 200), (4096, 1024)):
        route = fused_mel.mel_route(n_fft, hop)
        fb_n = torch.as_tensor(mel_filterbank(SR, n_fft, 80), device=dev)
        k1_checks[f"{n_fft}/{hop}"] = compare(k1_at(n_fft, hop),
                                              mel_plain(y, fb_n, n_fft, hop, n_fft),
                                              2e-3, 2e-3) | {"route": route}
    fb = torch.as_tensor(mel_filterbank(SR, 1280, 80), device=dev)

    def k1():
        return k1_at(1280, 320)

    def k1_plain():
        return mel_plain(y, fb, 1280, 320, 1280)

    def k1_library():
        yp = F.pad(y[:, None], (480, 480), mode="reflect")[:, 0]
        z = torch.stft(yp, 1280, 320, 1280, win, center=False, return_complex=True)
        return torch.log(torch.clamp(fb @ torch.sqrt(z.abs() ** 2 + 1e-6), min=1e-5))

    # The least work a log-mel needs: per frame a real FFT (2.5 N log2 N flops),
    # the window, |z|^2 over 641 bins and the mel product over the filters'
    # nonzero bands; bytes are the wave, the nonzero filter taps and the output.
    frames = t_len // 320
    nnz = int((fb != 0).sum())
    flops = (2.5 * 1280 * np.log2(1280) + 1280 + 3 * 641 + 2 * nnz) * frames
    nbytes = 4 * (t_len + nnz + frames * 80)
    results.append(dict(
        name="wave_to_mel", tpu_id="K1", source="quickvc_tpu_torch/csrc/fused_mel.cu",
        replaces="quickvc_tpu/ops/fused_mel.py:227", mel_route=fused_mel.mel_route(1280, 320),
        shape=[list(y.shape), [1, frames, 80]], **merge_checks(k1_checks),
        # in turns: library, kernel, kernel, library
        **turns(k1, k1_library), plain_ms=cuda_ms(k1_plain),
        ms_2048=cuda_ms(lambda: k1_at(2048, 512)), ms_800_dense=cuda_ms(lambda: k1_at(800, 200)),
        ms_4096_dense=cuda_ms(lambda: k1_at(4096, 1024)),
        bound_ops_ms=flops / F32_FLOPS * 1e3, bound_bytes_ms=nbytes / HBM_BYTES * 1e3))

    # K2 at one HuBERT layer of the 5-s source bucket, (8, 250, 768), views of
    # qkv; checked again at the streaming run's buckets and the live windows
    def k2_inputs(b: int, t: int, seed: int):
        qkv = torch.randn(b, t, 3 * 768, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed))
        return qkv.chunk(3, dim=-1)

    def k2_check(q, k, v) -> dict:
        return compare(fused_attention.attention_packed_kernel(q, k, v, 12, 0.125),
                       fused_attention.attention_packed_reference(q, k, v, 12, 0.125),
                       1e-4, 1e-3)

    b, t_u, d = BATCH, 5 * SR // 320, 768
    q, k, v = k2_inputs(b, t_u, SEED)
    qh, kh, vh = (z.reshape(b, t_u, 12, 64).transpose(1, 2).contiguous() for z in (q, k, v))
    k2_shapes = ([(b, t_u), *((BATCH, t) for t in shapes["stream_frames"])]
                 + [(LIVE_STREAMS, t) for t in shapes["live_windows"]])
    k2_checks = {str((n, t, d)): k2_check(*k2_inputs(n, t, SEED + i))
                 for i, (n, t) in enumerate(k2_shapes)}

    def k2():
        return fused_attention.attention_packed_kernel(q, k, v, 12, 0.125)

    def k2_plain():
        return fused_attention.attention_packed_reference(q, k, v, 12, 0.125)

    def k2_library():
        return F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)

    results.append(dict(
        name="attention_packed", tpu_id="K2", source="quickvc_tpu_torch/csrc/fused_attention.cu",
        replaces="quickvc_tpu/ops/fused_attention.py:113",
        shape=[[b, t_u, d]] * 3, **merge_checks(k2_checks),
        **turns(k2, k2_library), plain_ms=cuda_ms(k2_plain),
        **attention_bounds(4 * b * t_u * t_u * d, 4 * 4 * b * t_u * d)))
    results.append(check_attention_bf16(dev, shapes))

    # K3 at the decoder head of the same batch: 4 bands x 8 rows, 20*250+1 frames,
    # read as strided views of the subband conv output like the decoder does;
    # checked again at the streaming, live and parity-session windows
    def k3_inputs(rows: int, f: int, seed: int):
        conv_out = 0.5 * torch.randn(rows, 18, f, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(seed))
        spec = conv_out.transpose(1, 2)
        return spec[..., :9], spec[..., 9:]

    def k3_check(lm, ph, n_fft: int = 16, hop: int = 4) -> dict:
        return compare(fused_istft.polar_inverse_stft_kernel(lm, ph, n_fft, hop),
                       istft_plain(lm, ph, n_fft, hop), 1e-4, 1e-3)

    rows, f = 4 * BATCH, 20 * t_u + 1
    lm, ph = k3_inputs(rows, f, SEED + 1)
    k3_shapes = [(rows, t_u), (4 * BATCH, shapes["stream_window"]),
                 *((4 * LIVE_STREAMS, w) for w in shapes["live_windows"]),
                 (4, min(shapes["live_windows"])), (4 * 2, shapes["parity_window"])]
    k3_checks = {str((n, 20 * w + 1, 9)): k3_check(*k3_inputs(n, 20 * w + 1, SEED + 1 + i))
                 for i, (n, w) in enumerate(k3_shapes)}
    # the table-driven body at n_fft/hop 32/8: the same batch's samples in
    # 10*250+1 frames of 17 bins
    spec32 = 0.5 * torch.randn(rows, 34, 10 * t_u + 1, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    lm32, ph32 = spec32.transpose(1, 2)[..., :17], spec32.transpose(1, 2)[..., 17:]
    k3_checks[str((rows, 10 * t_u + 1, 17)) + " 32/8"] = k3_check(lm32, ph32, 32, 8)

    def k3():
        return fused_istft.polar_inverse_stft_kernel(lm, ph, 16, 4)

    def k3_plain():
        return istft_plain(lm, ph, 16, 4)

    hann16 = torch.hann_window(16, device=dev)

    def k3_library():
        z = torch.polar(torch.exp(lm), torch.pi * torch.sin(ph)).transpose(1, 2)
        return torch.istft(z, 16, 4, 16, hann16, center=True)

    # device time at the streaming window and the live windows of 64 streams
    # and of one beside the conversion's; and at the conversion's with the L2
    # flushed before each launch (the decoder's conv writes K3's input just
    # before it, so warm is the caller's case)
    k3_device = {}
    for i, (n, w) in enumerate([(4 * BATCH, shapes["stream_window"]),
                                *((4 * LIVE_STREAMS, w) for w in shapes["live_windows"]),
                                (4, min(shapes["live_windows"]))]):
        lm_w, ph_w = k3_inputs(n, 20 * w + 1, SEED + 20 + i)
        k3_device[str((n, 20 * w + 1, 9))] = device_ms(
            lambda lm_w=lm_w, ph_w=ph_w: fused_istft.polar_inverse_stft_kernel(lm_w, ph_w, 16, 4))

    results.append(dict(
        name="polar_inverse_stft", tpu_id="K3", source="quickvc_tpu_torch/csrc/fused_istft.cu",
        replaces="quickvc_tpu/ops/fused_istft.py:159",
        shape=[[rows, f, 9]] * 2, **merge_checks(k3_checks),
        deterministic=bool(torch.equal(k3(), k3())),
        # in turns: library, kernel, kernel, library
        **turns(k3, k3_library), plain_ms=cuda_ms(k3_plain),
        device_ms_shapes=k3_device,
        l2_cold_device_ms=device_ms(k3, between=l2_flush(dev), only="polar_istft"),
        ms_32_8=cuda_ms(lambda: fused_istft.polar_inverse_stft_kernel(lm32, ph32, 32, 8)),
        bound_ops_ms=rows * 4 * (f - 1) * 2 * 72 / F32_FLOPS * 1e3,
        bound_bytes_ms=4 * (2 * rows * f * 9 + rows * 4 * (f - 1)) / HBM_BYTES * 1e3))
    results[-1]["within_tol"] = results[-1]["within_tol"] and results[-1]["deterministic"]

    results += check_training_kernels(dev, rng)
    results += check_encoding_kernels(dev, rng)
    results += check_attention_layouts(dev)
    results += check_bf16_modes(dev)
    results += check_conv5_bf16(dev)
    results += check_gemm_kernels(dev)
    for r in results:
        r["bound_ms"] = max(r["bound_ops_ms"], r["bound_bytes_ms"])
        r["bound_by"] = "operations" if r["bound_ops_ms"] >= r["bound_bytes_ms"] else "bytes"
    return results


def check_conv5_bf16(dev: torch.device) -> list[dict]:
    """The bf16 modes of K5 (forward, dx) and K6 (dW) at every period
    discriminator's fifth conv of the paired D phase, x (64 p, R_p, 1024) in
    bf16, and at two shapes whose channels are not multiples of 8 (the
    gathered copies): against their plain versions and the float32 kernels
    on the same bf16-valued inputs (``bf16_gate``), a second launch of each
    bit-equal, each on the body the host picks (the TMA + wgmma body at the
    period shapes, the mma.sync body at the odd ones: read from the
    counters, a shape on the other body fails); at p = 2 and 11 timed in
    turns with the mma.sync body (by its entry, on the same inputs) and with
    cuDNN's bf16 conv and its input and weight gradients (transposed before
    the timing), with each call's plan and the wgmma body's blocks an SM,
    registers and local (spill) bytes. Its own seeds, and torch's
    generators restored after it."""
    with torch.random.fork_rng(devices=[dev]):
        return _check_conv5_bf16(dev)


def _check_conv5_bf16(dev: torch.device) -> list[dict]:
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_disc_conv as fdc
    from quickvc_tpu_torch.scripts.kernel_times import conv5_dw_mma_sync, conv5_mma_sync

    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {f"p{p}": (n, rows, c, c)
              for p, (n, rows, c) in fdc.disc_conv5_shapes(DISC_BATCH, SEGMENT).items()}
    shapes |= {"(5, 13, 30, 42)": (5, 13, 30, 42), "(4, 12, 33, 17)": (4, 12, 33, 17)}
    checks, dw_checks, timings, bodies, deterministic = {}, {}, {}, {}, True

    def on_body(stats, call):   # (output, the body that ran it)
        before = stats.launches
        out = call()
        return out, "wgmma" if stats.launches > before else "mma_sync"

    for i, (key, (n, rows, c_in, c_out)) in enumerate(shapes.items()):
        g = torch.Generator(device=dev).manual_seed(SEED + 60 + i)
        x = torch.randn(n, rows, c_in, device=dev, generator=g).to(bf)
        k = (torch.randn(5, c_in, c_out, device=dev, generator=g) / np.sqrt(5 * c_in)).to(bf)
        b = (0.1 * torch.randn(c_out, device=dev, generator=g)).to(bf)
        dy = (torch.randn(n, rows, c_out, device=dev, generator=g) / np.sqrt(n * rows)).to(bf)
        y, body_y = on_body(fdc.WGMMA_STATS, lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1))
        # dym as the backward forms it: bf16(lrelu') from the kernel's output, rounded
        dym = (dy * torch.where(y > 0, 1.0, 0.1).to(bf)).contiguous()
        k_flip = k.flip(0).transpose(1, 2).contiguous()
        dx, body_dx = on_body(fdc.WGMMA_STATS,
                              lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0))
        dw, body_dw = on_body(fdc.DW_WGMMA_STATS, lambda: fdc.conv5_dw_kernel(x, dym))
        bodies[key] = {"y": body_y, "dx": body_dx, "dw": body_dw}
        checks[f"{key} y"] = bf16_gate(y, fdc.conv5_lrelu_reference_bf16(x, k, b, 0.1),
                                       fdc.conv5_lrelu_kernel(x.float(), k.float(), b.float(),
                                                              0.1))
        checks[f"{key} dx"] = bf16_gate(dx, fdc.conv5_lrelu_reference_bf16(dym, k_flip, None, 1.0),
                                        fdc.conv5_lrelu_kernel(dym.float(), k_flip.float(), None,
                                                               1.0))
        dw_checks[key] = bf16_gate(dw, fdc.conv5_dw_reference(x, dym),
                                   fdc.conv5_dw_kernel(x.float(), dym.float()))
        deterministic &= bool(torch.equal(fdc.conv5_lrelu_kernel(x, k, b, 0.1), y)
                              and torch.equal(fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0), dx)
                              and torch.equal(fdc.conv5_dw_kernel(x, dym), dw))
        if key in ("p2", "p11"):
            x_ncr = x.transpose(1, 2).contiguous()        # cuDNN's (N, C, R) layout
            w_oik = k.permute(2, 1, 0).contiguous()       # (C_out, C_in, 5)
            dym_ncr = dym.transpose(1, 2).contiguous()
            flops = 2 * n * rows * 5 * c_in * c_out
            plans = {"forward": fdc.conv5_wgmma_plan(False, n, rows, c_in, c_out, sms),
                     "dx": fdc.conv5_wgmma_plan(False, n, rows, c_out, c_in, sms),
                     "dw": fdc.conv5_wgmma_plan(True, n, rows, c_in, c_out, sms)}
            k5_mma = lambda: conv5_mma_sync(x, k, b, 0.1)              # noqa: E731
            dx_mma = lambda: conv5_mma_sync(dym, k_flip, None, 1.0)    # noqa: E731
            dw_mma = lambda: conv5_dw_mma_sync(x, dym)                 # noqa: E731
            timings[key] = {
                "shape": [n, rows, c_in],
                "forward": turns(lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1),
                                 lambda: F.leaky_relu(F.conv1d(x_ncr, w_oik, b, padding=2), 0.1)),
                "dx": turns(lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0),
                            lambda: torch.nn.grad.conv1d_input(x_ncr.shape, w_oik, dym_ncr,
                                                               padding=2)),
                "dw": turns(lambda: fdc.conv5_dw_kernel(x, dym),
                            lambda: torch.nn.grad.conv1d_weight(x_ncr, w_oik.shape, dym_ncr,
                                                                padding=2)),
                # the body the wgmma one replaced here, in turns with it (its
                # "library" keys), and how far apart the two bodies' outputs lie
                "forward_mma_sync": turns(lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1), k5_mma),
                "dx_mma_sync": turns(lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0),
                                     dx_mma),
                "dw_mma_sync": turns(lambda: fdc.conv5_dw_kernel(x, dym), dw_mma),
                "mma_sync_max_abs_diff": {
                    "forward": float((k5_mma().float() - y.float()).abs().max()),
                    "dx": float((dx_mma().float() - dx.float()).abs().max()),
                    "dw": float((dw_mma().float() - dw.float()).abs().max())},
                "plain_ms": cuda_ms(lambda: fdc.conv5_lrelu_reference_bf16(x, k, b, 0.1)),
                "dx_plain_ms": cuda_ms(
                    lambda: fdc.conv5_lrelu_reference_bf16(dym, k_flip, None, 1.0)),
                "dw_plain_ms": cuda_ms(lambda: fdc.conv5_dw_reference(x, dym)),
                "plans": {name: plan._asdict() | {"workspace_bytes": 4 * plan.workspace}
                          | fdc.conv5_wgmma_attributes(name == "dw", plan.bn)
                          for name, plan in plans.items()},
                "dw_plan_mma_sync": fdc.dw_plan(n, rows, c_in, c_out, sms,
                                                fdc.BF16_TILING)._asdict(),
                # bf16 products; bytes: x and the filter (or dym) in, the output out
                "bound_ops_ms": flops / BF16_FLOPS * 1e3,
                "bound_bytes_ms": 2 * (n * rows * (c_in + c_out) + 5 * c_in * c_out)
                / HBM_BYTES * 1e3}
            del x_ncr, w_oik, dym_ncr
        del x, k, b, dy, y, dym, k_flip, dx, dw

    want = {key: {op: "wgmma" if key.startswith("p") else "mma_sync" for op in ("y", "dx", "dw")}
            for key in shapes}
    print("conv5_bf16_bodies " + json.dumps({"bodies": bodies, "expected": want}))
    t2 = timings["p2"]
    k5, k6 = merge_checks(checks), merge_checks(dw_checks)
    on_body_ok = bodies == want
    k5["within_tol"] = k5["within_tol"] and deterministic and on_body_ok
    k6["within_tol"] = k6["within_tol"] and deterministic and on_body_ok
    bounds = {key: t2[key] for key in ("bound_ops_ms", "bound_bytes_ms")}
    source = "quickvc_tpu_torch/csrc/conv5_wgmma.cu"
    return [dict(name="conv5_lrelu_bf16", tpu_id="K5", source=source,
                 replaces="quickvc_tpu/ops/fused_disc_conv.py:117", shape=t2["shape"], **k5,
                 deterministic=deterministic, bodies=bodies, **t2["forward"],
                 plain_ms=t2["plain_ms"], dx_ms=t2["dx"]["ms"],
                 dx_device_ms=t2["dx"]["device_ms"], dx_plain_ms=t2["dx_plain_ms"],
                 dx_library_ms=t2["dx"]["library_ms"],
                 dx_library_device_ms=t2["dx"]["library_device_ms"], timings=timings,
                 **bounds),
            dict(name="conv5_lrelu_dw_bf16", tpu_id="K6", source=source,
                 replaces="quickvc_tpu/ops/fused_disc_conv.py:156", shape=t2["shape"], **k6,
                 deterministic=deterministic, bodies=bodies, **t2["dw"],
                 plain_ms=t2["dw_plain_ms"], plan=t2["plans"]["dw"], **bounds)]


def check_attention_bf16(dev: torch.device, shapes: dict) -> dict:
    """K2's bf16 mode at the conversion's HuBERT shape (8, 250, 768), the live
    wave windows of 64 streams and a ragged T, against its plain version on
    the same bf16 inputs: max |kernel - plain| <= 8e-3 max|v|, and the
    kernel's max error against float64 attention of those inputs at most
    1.5x the plain version's (PERF.md section 2), two launches bit-equal;
    timed in turns with SDPA on the same bf16 (B, H, T, 64) inputs; the
    plan each shape takes (``bf16_attention_plan``) beside it."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_attention as fa

    def inputs(b: int, t: int, seed: int):
        qkv = torch.randn(b, t, 3 * 768, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(seed))
        return qkv.bfloat16().chunk(3, dim=-1)

    def exact(q, k, v):
        b, t, _ = q.shape
        qh, kh, vh = (z.double().reshape(b, t, 12, 64).transpose(1, 2) for z in (q, k, v))
        o = torch.softmax(qh @ kh.transpose(-1, -2) * 0.125, dim=-1) @ vh
        return o.transpose(1, 2).reshape(b, t, 768)

    def check(q, k, v) -> dict:
        ours = fa.attention_packed_kernel(q, k, v, 12, 0.125)
        plain = fa.attention_packed_reference(q, k, v, 12, 0.125)
        ref = exact(q, k, v)
        err_k, err_p = (float((x.double() - ref).abs().max()) for x in (ours, plain))
        tol = 8e-3 * float(v.float().abs().max())
        diff = (ours.float() - plain.float()).abs()
        same = bool(torch.equal(ours, fa.attention_packed_kernel(q, k, v, 12, 0.125)))
        b, t, _ = q.shape
        return {"max_abs_err": float(diff.max()),
                "max_rel_err": float((diff / plain.float().abs().clamp(min=1e-12)).max()),
                "err_f64_kernel": err_k, "err_f64_plain": err_p, "atol": tol, "rtol": 0.0,
                "dtype": str(ours.dtype), "deterministic": same,
                "plan": fa.bf16_attention_plan(b, 12, t, 64, sms)._asdict(),
                "within_tol": bool(ours.dtype == torch.bfloat16 and float(diff.max()) <= tol
                                   and err_k <= 1.5 * err_p and same)}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, t_u = BATCH, 5 * SR // 320
    k2b_shapes = [(b, t_u), *((LIVE_STREAMS, t) for t in shapes["live_windows"]), (3, 333)]
    checks = {str((n, t, 768)): check(*inputs(n, t, SEED + 40 + i))
              for i, (n, t) in enumerate(k2b_shapes)}
    deterministic = all(c["deterministic"] for c in checks.values())
    q, k, v = inputs(b, t_u, SEED + 39)
    qh, kh, vh = (z.reshape(b, t_u, 12, 64).transpose(1, 2).contiguous() for z in (q, k, v))
    flops, nbytes = 4 * b * t_u * t_u * 768, 4 * 2 * b * t_u * 768
    return dict(
        name="attention_packed_bf16", tpu_id="K2",
        source="quickvc_tpu_torch/csrc/fused_attention_bf16.cuh",
        replaces="quickvc_tpu/ops/fused_attention.py:113", shape=[[b, t_u, 768]] * 3,
        **merge_checks(checks), deterministic=deterministic,
        **turns(lambda: fa.attention_packed_kernel(q, k, v, 12, 0.125),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)),
        plain_ms=cuda_ms(lambda: fa.attention_packed_reference(q, k, v, 12, 0.125)),
        bound_ops_ms=flops / BF16_FLOPS * 1e3, bound_bytes_ms=nbytes / HBM_BYTES * 1e3)


def check_training_kernels(dev: torch.device, rng: np.random.Generator) -> list[dict]:
    """K4 at the full compact training batch; K5 (forward, dx) and K6 (dW)
    at every period discriminator's fifth conv of the paired D phase."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.dsp.stft import hann_window, wave_to_spec_halo as spec_plain
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc
    from quickvc_tpu_torch.ops import fused_mel

    results = []
    # K4: (32, 512*320 + 960) s16 crops / 32768 -> (32, 512, 641); held
    # against its plain version there and at n_fft/hop 1024/256
    def k4_wave(frames: int, n_fft: int, hop: int, rng: np.random.Generator) -> torch.Tensor:
        t_len = frames * hop + n_fft - hop
        return torch.from_numpy(np.stack([
            np.round(synth_voice((t_len + 1) / SR, SR, rng)[:t_len] * 32767) / 32768.0
            for _ in range(TRAIN_BATCH)]).astype(np.float32)).to(dev)

    frames = 512
    y = k4_wave(frames, 1280, 320, rng)
    y1024 = k4_wave(frames, 1024, 256, np.random.default_rng(SEED + 4))
    y800 = k4_wave(frames, 800, 200, np.random.default_rng(SEED + 6))   # the dense route

    def k4_800():
        return fused_mel.wave_to_spec_halo_kernel(y800, 800, 200, 800)

    k4_checks = {
        "1280/320": compare(fused_mel.wave_to_spec_halo_kernel(y, 1280, 320, 1280),
                            spec_plain(y, 1280, 320, 1280), 2e-4, 2e-4),
        "1024/256": compare(fused_mel.wave_to_spec_halo_kernel(y1024, 1024, 256, 1024),
                            spec_plain(y1024, 1024, 256, 1024), 2e-4, 2e-4),
        "800/200 (dense)": compare(k4_800(), spec_plain(y800, 800, 200, 800), 2e-4, 2e-4)}
    dense = {"dense_800_ms": cuda_ms(k4_800),
             "dense_800_plain_ms": cuda_ms(lambda: spec_plain(y800, 800, 200, 800)),
             "dense_800_bound_ms": max(
                 (2.5 * 800 * np.log2(800) + 800 + 4 * 401) * TRAIN_BATCH * frames / F32_FLOPS,
                 4 * (y800.numel() + TRAIN_BATCH * frames * 401) / HBM_BYTES) * 1e3}
    del y1024, y800
    win = torch.as_tensor(hann_window(1280), device=dev)

    def k4():
        return fused_mel.wave_to_spec_halo_kernel(y, 1280, 320, 1280)

    def k4_plain():
        return spec_plain(y, 1280, 320, 1280)

    def k4_library():
        z = torch.stft(y, 1280, 320, 1280, win, center=False, return_complex=True)
        return torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-6).transpose(1, 2)

    # least work: a real FFT (2.5 N log2 N), the window and |z|^2 + sqrt per
    # frame; bytes: the wave in, the spectrogram out
    n_fr = TRAIN_BATCH * frames
    results.append(dict(
        name="wave_to_spec_halo", tpu_id="K4", source="quickvc_tpu_torch/csrc/fused_mel.cu",
        replaces="quickvc_tpu/ops/fused_mel.py:177",
        shape=[list(y.shape), [TRAIN_BATCH, frames, 641]], **merge_checks(k4_checks),
        # in turns: library, kernel, kernel, library
        **turns(k4, k4_library), plain_ms=cuda_ms(k4_plain), **dense,
        bound_ops_ms=(2.5 * 1280 * np.log2(1280) + 1280 + 4 * 641) * n_fr / F32_FLOPS * 1e3,
        bound_bytes_ms=4 * (y.numel() + n_fr * 641) / HBM_BYTES * 1e3))
    del y

    # K5/K6 at each period discriminator's fifth conv of the paired D phase,
    # x (64 p, R_p, 1024), filter (5, 1024, 1024); inputs scaled so that y,
    # dx and dW are all O(1). Each is held against its plain version at all
    # five periods; p = 2 (the longest rows) and p = 11 (R = 12, where the
    # SAME padding and item edges are a third of the rows) are timed in turns
    # with cuDNN (TF32 off).
    checks, dw_checks, timings = {}, {}, {}
    function_ok = deterministic = None
    for p, (n, rows, c) in fdc.disc_conv5_shapes(DISC_BATCH, SEGMENT).items():
        g = torch.Generator(device=dev).manual_seed(SEED + 5 + p)
        x = torch.randn(n, rows, c, device=dev, generator=g)
        k = torch.randn(5, c, c, device=dev, generator=g) / np.sqrt(5 * c)
        b = 0.1 * torch.randn(c, device=dev, generator=g)
        dy = torch.randn(n, rows, c, device=dev, generator=g) / np.sqrt(n * rows)
        # the backward kernels against their plain versions on the same dym,
        # the LReLU mask taken from the kernel's own output (where |y| is at
        # rounding level the mask's sign is not determined, so autograd of
        # the plain forward may mask other elements)
        y_out = fdc.conv5_lrelu_kernel(x, k, b, 0.1)
        dym = (dy * torch.where(y_out > 0, 1.0, 0.1)).contiguous()
        k_flip = k.flip(0).transpose(1, 2).contiguous()
        xp = F.pad(x, (0, 0, 2, 2))

        def k6_plain(xp=xp, dym=dym, rows=rows):
            return torch.stack([torch.einsum("nrc,nro->co", xp[:, dr : dr + rows], dym)
                                for dr in range(5)])

        dx = fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0)
        dw = fdc.conv5_dw_kernel(x, dym)
        checks[f"p{p} y"] = compare(y_out, fdc.conv5_lrelu_reference(x, k, b, 0.1), 1e-4, 1e-3)
        checks[f"p{p} dx"] = compare(dx, fdc.conv5_lrelu_reference(dym, k_flip, None, 1.0),
                                     1e-4, 1e-3)
        dw_checks[f"p{p}"] = compare(dw, k6_plain(), 1e-4, 1e-3)
        if p == 2:
            # the autograd.Function launches exactly these kernels (db = sum
            # of dym), and a second launch of each gives the same bits
            ins = [t.clone().requires_grad_() for t in (x, k, b)]
            fdc.conv5_lrelu(*ins, 0.1).backward(dy)
            function_ok = (torch.equal(ins[0].grad, dx) and torch.equal(ins[1].grad, dw)
                           and torch.equal(ins[2].grad, dym.sum(dim=(0, 1))))
            deterministic = (torch.equal(fdc.conv5_dw_kernel(x, dym), dw)
                             and torch.equal(fdc.conv5_lrelu_kernel(x, k, b, 0.1), y_out))
            del ins
        if p in (2, 11):
            x_ncr = x.transpose(1, 2).contiguous()        # cuDNN's (N, C, R) layout
            w_oik = k.permute(2, 1, 0).contiguous()       # (C_out, C_in, 5)
            dym_ncr = dym.transpose(1, 2).contiguous()
            flops = 2 * n * rows * 5 * c * c
            timings[f"p{p}"] = {
                "shape": [n, rows, c],
                "forward": turns(lambda: fdc.conv5_lrelu_kernel(x, k, b, 0.1),
                                 lambda: F.leaky_relu(F.conv1d(x_ncr, w_oik, b, padding=2), 0.1)),
                "dx": turns(lambda: fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0),
                            lambda: torch.nn.grad.conv1d_input(x_ncr.shape, w_oik, dym_ncr,
                                                               padding=2)),
                "dw": turns(lambda: fdc.conv5_dw_kernel(x, dym),
                            lambda: torch.nn.grad.conv1d_weight(x_ncr, w_oik.shape, dym_ncr,
                                                                padding=2)),
                "plain_ms": cuda_ms(lambda: fdc.conv5_lrelu_reference(x, k, b, 0.1)),
                "dx_plain_ms": cuda_ms(lambda: fdc.conv5_lrelu_reference(dym, k_flip, None, 1.0)),
                "dw_plain_ms": cuda_ms(k6_plain),
                "dw_plan": fdc.dw_plan(n, rows, c, c,
                                       torch.cuda.get_device_properties(dev).multi_processor_count
                                       )._asdict(),
                # 3xTF32: three TF32 products a float32-accurate one; bytes:
                # x and the filter (or dym) in, the output out
                "bound_ops_ms": 3 * flops / TF32_FLOPS * 1e3,
                "bound_bytes_ms": 4 * (2 * n * rows * c + 5 * c * c) / HBM_BYTES * 1e3,
                "bound_f32_fma_ms": flops / F32_FLOPS * 1e3}
            del x_ncr, w_oik, dym_ncr
        del x, k, b, dy, y_out, dym, k_flip, xp, dx, dw

    t2 = timings["p2"]
    k5 = merge_checks(checks)
    k5["within_tol"] = k5["within_tol"] and function_ok and deterministic
    k6 = merge_checks(dw_checks)
    k6["within_tol"] = k6["within_tol"] and deterministic
    bounds = {key: t2[key] for key in ("bound_ops_ms", "bound_bytes_ms", "bound_f32_fma_ms")}
    results.append(dict(
        name="conv5_lrelu", tpu_id="K5", source="quickvc_tpu_torch/csrc/fused_disc_conv.cu",
        replaces="quickvc_tpu/ops/fused_disc_conv.py:117", shape=t2["shape"], **k5,
        autograd_function_ok=function_ok, deterministic=deterministic,
        **t2["forward"], plain_ms=t2["plain_ms"],
        dx_ms=t2["dx"]["ms"], dx_device_ms=t2["dx"]["device_ms"],
        dx_plain_ms=t2["dx_plain_ms"], dx_library_ms=t2["dx"]["library_ms"],
        dx_library_device_ms=t2["dx"]["library_device_ms"], timings=timings, **bounds))
    results.append(dict(
        name="conv5_lrelu_dw", tpu_id="K6", source="quickvc_tpu_torch/csrc/fused_disc_conv.cu",
        replaces="quickvc_tpu/ops/fused_disc_conv.py:156", shape=t2["shape"], **k6,
        deterministic=deterministic,
        **t2["dw"], plain_ms=t2["dw_plain_ms"], dw_plan=t2["dw_plan"], **bounds))
    return results


def check_encoding_kernels(dev: torch.device, rng: np.random.Generator) -> list[dict]:
    """K7 at the encoding batch's 6-s bucket, wave (16, 96000 + 80) -> (16, 9607,
    512); K8 at the hidden state of that batch, (16, 300, 768), and at one
    item, (1, 300, 768), whose GEMMs the plan splits. Each timed in turns with
    its library chain; bounds 3xTF32, the float32 FMA figure beside them."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_extractor as fe
    from quickvc_tpu_torch.ops import fused_transformer as ft
    from quickvc_tpu_torch.ops._cuda import library

    results = []
    b, t_len, c = ENCODE_BATCH, 6 * SR + 80, 512
    wav = torch.from_numpy(np.stack([synth_voice(6.0 + 0.01, SR, rng)[:t_len]
                                     for _ in range(b)])).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    w0 = 0.3 * torch.randn(c, 1, 10, device=dev, generator=g)
    gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
    beta = 0.1 * torch.randn(c, device=dev, generator=g)
    w1 = torch.randn(c, c, 3, device=dev, generator=g) / np.sqrt(3 * c)
    front = (wav, w0, gamma, beta, w1)

    def k7():
        return fe.extractor_front_kernel(*front)

    def k7_library():   # cuDNN's conv0 -> GroupNorm over its output -> GELU -> conv1 -> GELU
        y = F.gelu(F.group_norm(F.conv1d(wav[:, None], w0, stride=5), c, gamma, beta, 1e-5))
        return F.gelu(F.conv1d(y, w1, stride=2)).transpose(1, 2)

    plain = fe.extractor_front_reference(*front)
    ours = k7()
    deterministic = bool(torch.equal(k7(), ours))
    cmp = compare(ours, plain, 5e-4, 1e-3)
    n1, tc = fe.front_rows(t_len), (t_len - 10) // 5 + 1
    conv1_flops, conv0_flops = 2 * b * n1 * c * 3 * c, 2 * b * tc * c * 10
    results.append(dict(
        name="extractor_front", tpu_id="K7", source="quickvc_tpu_torch/csrc/fused_extractor.cu",
        replaces="quickvc_tpu/ops/fused_extractor.py:187", shape=[[b, t_len], [b, n1, c]],
        **(cmp | {"within_tol": cmp["within_tol"] and deterministic}),
        deterministic=deterministic,
        library_max_abs_err=float((k7_library() - plain).abs().max()),
        **turns(k7, k7_library, iters=10),
        plain_ms=cuda_ms(lambda: fe.extractor_front_reference(*front), iters=10),
        affine_ms=cuda_ms(lambda: fe.groupnorm_affine_closed_form(wav, w0, gamma, beta)),
        # conv1 in 3xTF32 (three TF32 products a float32-accurate one), conv0
        # on the FMA units; bytes: the wave, the weights and the output
        bound_ops_ms=(3 * conv1_flops / TF32_FLOPS + conv0_flops / F32_FLOPS) * 1e3,
        bound_bytes_ms=4 * (b * t_len + 12 * c + 3 * c * c + b * n1 * c) / HBM_BYTES * 1e3,
        bound_f32_fma_ms=(conv1_flops + conv0_flops) / F32_FLOPS * 1e3))
    del wav, front, plain, ours

    layer = seeded_layer(dev)
    lib_layer = torch.nn.TransformerEncoderLayer(768, 12, 3072, dropout=0.0, activation="gelu",
                                                 batch_first=True).to(dev).eval()
    lib_layer.load_state_dict(layer.state_dict())
    t_u, d, f = 300, 768, 3072
    x = torch.randn(b, t_u, d, device=dev, generator=g)
    x_one = torch.randn(1, t_u, d, device=dev, generator=g)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k8(z=x):
        return ft.transformer_layer_kernel(z, layer)

    def k8_library():
        with torch.inference_mode():
            return lib_layer(x)

    plain = ft.transformer_layer_reference(x, layer)
    ours, ours_one = k8(), k8(x_one)
    deterministic = bool(torch.equal(k8(), ours) and torch.equal(k8(x_one), ours_one))
    checks = {str([b, t_u, d]): compare(ours, plain, 1e-4, 1e-3),
              str([1, t_u, d]) + " split-K": compare(
                  ours_one, ft.transformer_layer_reference(x_one, layer), 1e-4, 1e-3)}
    merged = merge_checks(checks)
    plans = ft.layer_plans(b * t_u, d, f, sms)
    m = b * t_u
    flops = 2 * m * d * (4 * d + 2 * f) + 4 * b * 12 * t_u * t_u * 64
    results.append(dict(
        name="transformer_layer", tpu_id="K8",
        source="quickvc_tpu_torch/csrc/fused_transformer.cu",
        replaces="quickvc_tpu/ops/fused_transformer.py:155", shape=[[b, t_u, d]],
        **(merged | {"within_tol": merged["within_tol"] and deterministic}),
        deterministic=deterministic,
        library_max_abs_err=float((k8_library() - plain).abs().max()),
        launches_per_call=library().qvc_transformer_layer_launches(*[p.splits for p in plans]),
        plans={str([b, t_u, d]): [p._asdict() for p in plans],
               str([1, t_u, d]): [p._asdict() for p in ft.layer_plans(t_u, d, f, sms)]},
        **turns(k8, k8_library),
        ms_split_k=cuda_ms(lambda: k8(x_one)),
        plain_ms=cuda_ms(lambda: ft.transformer_layer_reference(x, layer)),
        # products and attention in 3xTF32; bytes: x, the weights, the output
        bound_ops_ms=3 * flops / TF32_FLOPS * 1e3,
        bound_bytes_ms=4 * (2 * m * d + 4 * d * d + 2 * d * f + 9 * d + f) / HBM_BYTES * 1e3,
        bound_f32_fma_ms=flops / F32_FLOPS * 1e3))
    return results


def seeded_layer(dev: torch.device):
    """A seeded full-width HuBERT layer with its biases and norm affines off
    their init constants, fused (K8), on ``dev``."""
    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.utils.weights import init_random_

    layer = init_random_(TransformerLayer(use_fused_layer=True), SEED + 8)
    gen = torch.Generator().manual_seed(SEED + 8)
    with torch.no_grad():
        for prm in layer.parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
    return layer.to(dev).eval()


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7)) if x > 0 else 0.0


def bf16_gate(ours: torch.Tensor, plain: torch.Tensor, ref32: torch.Tensor) -> dict:
    """A bf16 mode's gates on one shape (PERF.md section 2): max|ours - plain|
    within BF16_GATE max|plain| or two bf16 ulps of it, and ours' max error
    against the float32 kernel ``ref32`` on the same bf16-valued inputs at
    most BF16_F32_RATIO times the plain version's."""
    diff = (ours.float() - plain.float()).abs()
    peak = float(plain.float().abs().max())
    tol = max(BF16_GATE * peak, 2 * bf16_ulp(peak))
    err_k, err_p = (float((z.float() - ref32.float()).abs().max()) for z in (ours, plain))
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / plain.float().abs().clamp(min=1e-12)).max()),
            "atol": tol, "rtol": 0.0, "err_f32_kernel": err_k, "err_f32_plain": err_p,
            "dtype": str(ours.dtype),
            "within_tol": bool(ours.dtype == torch.bfloat16 and bool(torch.isfinite(ours).all())
                               and float(diff.max()) <= tol and err_k <= BF16_F32_RATIO * err_p)}


def check_bf16_modes(dev: torch.device) -> list[dict]:
    """The bf16 modes of K7 (the encoding batch's 6-s bucket, (16, 96080) ->
    (16, 9607, 512)), K8 ((16, 300, 768) and, split-K, (1, 300, 768)), K9
    ((8, 250, 12*128)) and K10 ((8, 12, 250, 64) and (2, 3, 50, 16)) on bf16
    inputs and float32 parameters, as the models hand them over, against
    their plain versions and the float32 kernels (``bf16_gate``); each timed
    in turns with its bf16 library call: cuDNN's bf16 chain (K7),
    ``nn.TransformerEncoderLayer`` in bf16 (K8), bf16 SDPA (K9, K10). Its own
    seeds, and torch's generators restored after it, so that the phases
    after it draw what they drew before it was added."""
    with torch.random.fork_rng(devices=[dev]):
        return _check_bf16_modes(dev, np.random.default_rng(SEED + 13))


def _check_bf16_modes(dev: torch.device, rng: np.random.Generator) -> list[dict]:
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_attention as fa
    from quickvc_tpu_torch.ops import fused_extractor as fe
    from quickvc_tpu_torch.ops import fused_transformer as ft
    from quickvc_tpu_torch.scripts.kernel_times import k7_bf16_library

    bf, results = torch.bfloat16, []
    b, t_len, c = ENCODE_BATCH, 6 * SR + 80, 512
    wav = torch.from_numpy(np.stack([synth_voice(6.0 + 0.01, SR, rng)[:t_len]
                                     for _ in range(b)])).to(dev).to(bf)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    w0 = 0.3 * torch.randn(c, 1, 10, device=dev, generator=g)
    gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
    beta = 0.1 * torch.randn(c, device=dev, generator=g)
    w1 = torch.randn(c, c, 3, device=dev, generator=g) / np.sqrt(3 * c)
    front = (wav, w0, gamma, beta, w1)
    w0b, w1b = w0.to(bf), w1.to(bf)
    k7_library = k7_bf16_library(*front)   # cuDNN's bf16 chain

    def k7():
        return fe.extractor_front_kernel(*front)

    before = fe.WGMMA_STATS.launches
    ours = k7()
    body = "wgmma" if fe.WGMMA_STATS.launches == before + 1 else "mma_sync"
    plain, ref32 = fe.extractor_front_reference(*front), fe.extractor_front_kernel(
        wav.float(), w0b.float(), gamma, beta, w1b.float())
    gate = bf16_gate(ours, plain, ref32)
    deterministic = bool(torch.equal(k7(), ours))
    del plain, ref32
    n1, tc = fe.front_rows(t_len), (t_len - 10) // 5 + 1
    conv1_flops, conv0_flops = 2 * b * n1 * c * 3 * c, 2 * b * tc * c * 10
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results.append(dict(
        name="extractor_front_bf16", tpu_id="K7",
        source=("quickvc_tpu_torch/csrc/extractor_wgmma.cu" if body == "wgmma"
                else "quickvc_tpu_torch/csrc/fused_extractor.cu"),
        replaces="quickvc_tpu/ops/fused_extractor.py:187", shape=[[b, t_len], [b, n1, c]],
        **(gate | {"within_tol": gate["within_tol"] and deterministic and body == "wgmma"}),
        deterministic=deterministic, body=body,
        plan=fe.front_wgmma_plan(b, n1, sms)._asdict(),
        **turns(k7, k7_library, iters=10),
        plain_ms=cuda_ms(lambda: fe.extractor_front_reference(*front), iters=10),
        # conv1 on bf16 tensor cores, conv0 on the float32 FMA units; bytes:
        # the bf16 wave, weights and output, the float32 affine
        bound_ops_ms=(conv1_flops / BF16_FLOPS + conv0_flops / F32_FLOPS) * 1e3,
        bound_bytes_ms=(2 * (b * t_len + 10 * c + 3 * c * c + b * n1 * c)
                        + 4 * 2 * b * c) / HBM_BYTES * 1e3))
    del wav, front, ours

    layer = seeded_layer(dev)
    # the float32 kernel's layer: the same parameters, its matrices bf16-valued
    layer32 = seeded_layer(dev)
    with torch.no_grad():
        for prm in layer32.parameters():
            if prm.dim() == 2:
                prm.copy_(prm.to(bf).float())
    lib_layer = torch.nn.TransformerEncoderLayer(768, 12, 3072, dropout=0.0, activation="gelu",
                                                 batch_first=True).to(dev).eval()
    lib_layer.load_state_dict(layer.state_dict())
    lib_layer = lib_layer.to(bf)
    t_u, d, f = 300, 768, 3072
    x = torch.randn(b, t_u, d, device=dev, generator=g).to(bf)
    x_one = torch.randn(1, t_u, d, device=dev, generator=g).to(bf)

    def k8(z=x):
        return ft.transformer_layer_kernel(z, layer)

    def k8_library():
        with torch.inference_mode():
            return lib_layer(x)

    checks = {str([b, t_u, d]): bf16_gate(k8(), ft.transformer_layer_reference(x, layer),
                                          ft.transformer_layer_kernel(x.float(), layer32)),
              str([1, t_u, d]) + " split-K": bf16_gate(
                  k8(x_one), ft.transformer_layer_reference(x_one, layer),
                  ft.transformer_layer_kernel(x_one.float(), layer32))}
    merged = merge_checks(checks)
    deterministic = bool(torch.equal(k8(), k8()) and torch.equal(k8(x_one), k8(x_one)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    m = b * t_u
    flops = 2 * m * d * (4 * d + 2 * f) + 4 * b * 12 * t_u * t_u * 64
    results.append(dict(
        name="transformer_layer_bf16", tpu_id="K8",
        source="quickvc_tpu_torch/csrc/fused_transformer.cu",
        replaces="quickvc_tpu/ops/fused_transformer.py:155", shape=[[b, t_u, d]],
        **(merged | {"within_tol": merged["within_tol"] and deterministic}),
        deterministic=deterministic,
        plans={str([b, t_u, d]): [p._asdict() for p in ft.wgmma_layer_plans(m, d, f, sms)],
               str([1, t_u, d]): [p._asdict() for p in ft.wgmma_layer_plans(t_u, d, f, sms)]},
        **turns(k8, k8_library), ms_split_k=cuda_ms(lambda: k8(x_one)),
        plain_ms=cuda_ms(lambda: ft.transformer_layer_reference(x, layer)),
        # bf16 products and attention; bytes: x, the bf16 weights, the
        # float32 vectors, the output
        bound_ops_ms=flops / BF16_FLOPS * 1e3,
        bound_bytes_ms=(2 * (2 * m * d + 4 * d * d + 2 * d * f) + 4 * (9 * d + f))
        / HBM_BYTES * 1e3))
    del layer, layer32, lib_layer, x, x_one

    a = attention_inputs(dev)
    q, k, v = (z.to(bf) for z in a["headed"])
    small = [z.to(bf) for z in a["headed_d16"]]
    bh, h, t_a, dh = q.shape
    checks = {"(8, 12, 250, 64)": bf16_gate(fa.attention_kernel(q, k, v, 0.125),
                                            fa.attention_reference(q, k, v, 0.125),
                                            fa.attention_kernel(q.float(), k.float(),
                                                                v.float(), 0.125)),
              "(2, 3, 50, 16)": bf16_gate(fa.attention_kernel(*small, 0.25),
                                          fa.attention_reference(*small, 0.25),
                                          fa.attention_kernel(*(z.float() for z in small),
                                                              0.25))}
    merged = merge_checks(checks)
    deterministic = bool(torch.equal(fa.attention_kernel(q, k, v, 0.125),
                                     fa.attention_kernel(q, k, v, 0.125))
                         and torch.equal(fa.attention_kernel(*small, 0.25),
                                         fa.attention_kernel(*small, 0.25)))
    results.append(dict(
        name="attention_bf16", tpu_id="K10",
        source="quickvc_tpu_torch/csrc/fused_attention_bf16.cuh",
        replaces="quickvc_tpu/ops/fused_attention.py:231", shape=[[bh, h, t_a, dh]] * 3,
        **(merged | {"within_tol": merged["within_tol"] and deterministic}),
        deterministic=deterministic,
        plans={"(8, 12, 250, 64)": fa.bf16_attention_plan(bh, h, t_a, dh, sms)._asdict(),
               "(2, 3, 50, 16)": fa.bf16_attention_plan(2, 3, 50, 16, sms)._asdict()},
        **turns(lambda: fa.attention_kernel(q, k, v, 0.125),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125)),
        plain_ms=cuda_ms(lambda: fa.attention_reference(q, k, v, 0.125)),
        bound_ops_ms=4 * bh * h * t_a * t_a * dh / BF16_FLOPS * 1e3,
        bound_bytes_ms=4 * 2 * bh * h * t_a * dh / HBM_BYTES * 1e3))

    qa, ka, va = (z.to(bf) for z in a["aligned"])
    heads = [z.reshape(bh, t_a, 12, 128).transpose(1, 2) for z in (qa, ka, va)]
    out = fa.attention_packed_aligned_kernel(qa, ka, va, 12, 0.125)
    gate = bf16_gate(out, fa.attention_packed_aligned_reference(qa, ka, va, 12, 0.125),
                     fa.attention_packed_aligned_kernel(qa.float(), ka.float(), va.float(), 12,
                                                        0.125))
    pad_zero = not bool(out.reshape(bh, t_a, 12, 128)[..., 64:].any())
    deterministic = bool(torch.equal(out, fa.attention_packed_aligned_kernel(qa, ka, va, 12,
                                                                             0.125)))
    results.append(dict(
        name="attention_packed_aligned_bf16", tpu_id="K9",
        source="quickvc_tpu_torch/csrc/fused_attention_bf16.cuh",
        replaces="quickvc_tpu/ops/fused_attention.py:194", shape=[[bh, t_a, 12 * 128]] * 3,
        **(gate | {"within_tol": gate["within_tol"] and pad_zero and deterministic}),
        padded_lanes_zero=pad_zero, deterministic=deterministic,
        plan=fa.bf16_attention_plan(bh, 12, t_a, 128, sms)._asdict(),
        **turns(lambda: fa.attention_packed_aligned_kernel(qa, ka, va, 12, 0.125),
                lambda: F.scaled_dot_product_attention(*heads, scale=0.125)),
        plain_ms=cuda_ms(lambda: fa.attention_packed_aligned_reference(qa, ka, va, 12, 0.125)),
        bound_ops_ms=4 * bh * 12 * t_a * t_a * 128 / BF16_FLOPS * 1e3,
        bound_bytes_ms=4 * 2 * bh * t_a * 12 * 128 / HBM_BYTES * 1e3))
    return results


def attention_inputs(dev: torch.device) -> dict:
    """Seeded q/k/v of K10 at (8, 12, 250, 64) and (2, 3, 50, 16), and of K9 at
    (8, 250, 12*128) with each head's 64 values zero-padded to 128 lanes."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, t_u = BATCH, 5 * SR // 320
    return {
        "headed": [torch.randn(b, 12, t_u, 64, device=dev, generator=g) for _ in range(3)],
        "headed_d16": [torch.randn(2, 3, 50, 16, device=dev, generator=g) for _ in range(3)],
        # views at strides and offsets that are not multiples of 4 floats
        # (the body's 4-byte copies)
        "headed_d16_unaligned": [torch.randn(2, 3, 50, 17, device=dev, generator=g)[..., 1:]
                                 for _ in range(3)],
        "aligned": [F.pad(torch.randn(b, t_u, 12, 64, device=dev, generator=g), (0, 64))
                    .reshape(b, t_u, 12 * 128) for _ in range(3)]}


def check_attention_layouts(dev: torch.device) -> list[dict]:
    """K10 on the headed layout at the conversion's HuBERT shape and at head
    dim 16; K9 over 128-lane heads. Library call: F.scaled_dot_product_attention
    on the same heads (for K9 the 128-lane views: the padded lanes are part
    of the function)."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_attention as fa

    x = attention_inputs(dev)
    q, k, v = x["headed"]
    b, h, t_u, d = q.shape
    checks = {"(8, 12, 250, 64)": compare(fa.attention_kernel(q, k, v, 0.125),
                                          fa.attention_reference(q, k, v, 0.125), 1e-4, 1e-3),
              "(2, 3, 50, 16)": compare(fa.attention_kernel(*x["headed_d16"], 0.25),
                                        fa.attention_reference(*x["headed_d16"], 0.25),
                                        1e-4, 1e-3),
              "(2, 3, 50, 16) unaligned": compare(
                  fa.attention_kernel(*x["headed_d16_unaligned"], 0.25),
                  fa.attention_reference(*x["headed_d16_unaligned"], 0.25), 1e-4, 1e-3)}
    results = [dict(
        name="attention", tpu_id="K10", source="quickvc_tpu_torch/csrc/fused_attention.cu",
        replaces="quickvc_tpu/ops/fused_attention.py:231", shape=[[b, h, t_u, d]] * 3,
        **merge_checks(checks),
        **turns(lambda: fa.attention_kernel(q, k, v, 0.125),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125)),
        plain_ms=cuda_ms(lambda: fa.attention_reference(q, k, v, 0.125)),
        **attention_bounds(4 * b * h * t_u * t_u * d, 4 * 4 * b * h * t_u * d))]

    qa, ka, va = x["aligned"]
    heads = [z.reshape(b, t_u, 12, 128).transpose(1, 2) for z in (qa, ka, va)]
    out = fa.attention_packed_aligned_kernel(qa, ka, va, 12, 0.125)
    cmp = compare(out, fa.attention_packed_aligned_reference(qa, ka, va, 12, 0.125), 1e-4, 1e-3)
    pad_zero = not bool(out.reshape(b, t_u, 12, 128)[..., 64:].any())
    results.append(dict(
        name="attention_packed_aligned", tpu_id="K9",
        source="quickvc_tpu_torch/csrc/fused_attention.cu",
        replaces="quickvc_tpu/ops/fused_attention.py:194", shape=[[b, t_u, 12 * 128]] * 3,
        **(cmp | {"within_tol": cmp["within_tol"] and pad_zero}), padded_lanes_zero=pad_zero,
        **turns(lambda: fa.attention_packed_aligned_kernel(qa, ka, va, 12, 0.125),
                lambda: F.scaled_dot_product_attention(*heads, scale=0.125)),
        plain_ms=cuda_ms(lambda: fa.attention_packed_aligned_reference(qa, ka, va, 12, 0.125)),
        **attention_bounds(4 * b * 12 * t_u * t_u * 128, 4 * 4 * b * t_u * 12 * 128)))
    return results


def check_gemm_kernels(dev: torch.device) -> list[dict]:
    """K11 at the int8 probe's full shape, (16384 x 12288) @ (12288 x 3072):
    int8 exact against the plain version (float64 product cast to int32), bf16
    atol 2e-3 / rtol 1e-4, a bf16 call's kernels as the profiler sees them
    (no B^T pre-pass). Library calls: torch._int_mm, bf16 torch.matmul, and
    torch.mm(..., out_dtype=torch.float32) where this torch has it."""
    from quickvc_tpu_torch.ops import int8_mm
    from quickvc_tpu_torch.scripts import int8_matmul_probe as probe
    from quickvc_tpu_torch.scripts.kernel_times import device_kernels

    m, kk, n = probe.M, probe.K, probe.N
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    a8 = torch.randint(-127, 128, (m, kk), device=dev, dtype=torch.int8, generator=g)
    b8 = torch.randint(-127, 128, (kk, n), device=dev, dtype=torch.int8, generator=g)
    b8_col = b8.t().contiguous().t()
    ours, ref = int8_mm.mm_kernel(a8, b8), int8_mm.mm_reference(a8, b8)
    err = float((ours.double() - ref.double()).abs().max())
    exact = bool(torch.equal(ours, ref))
    del ours, ref
    ops = 2 * m * kk * n
    results = [dict(
        name="mm_s8", tpu_id="K11", source="quickvc_tpu_torch/csrc/int8_mm.cu",
        replaces="scripts/int8_matmul_probe.py:85", shape=[[m, kk], [kk, n]],
        max_abs_err=err, max_rel_err=err, atol=0, rtol=0, within_tol=exact,
        tile=int8_mm.DEFAULT_TILE,
        **turns(lambda: int8_mm.mm_kernel(a8, b8), lambda: torch._int_mm(a8, b8), iters=10),
        transpose_ms=cuda_ms(lambda: int8_mm.transpose_b(b8), iters=10),
        # cuBLASLt's int8 kernels want B column-major: the same call on such a
        # copy, made before the timing
        library_b_col_major_ms=cuda_ms(lambda: torch._int_mm(a8, b8_col), iters=10),
        plain_ms=cuda_ms(lambda: int8_mm.mm_reference(a8, b8), iters=3, warmup=1),
        bound_ops_ms=ops / INT8_OPS * 1e3,
        bound_bytes_ms=(m * kk + kk * n + 4 * m * n) / HBM_BYTES * 1e3)]
    abf, bbf = ((x.float() / 127.0).bfloat16() for x in (a8, b8))
    del a8, b8, b8_col

    def f32_out():   # K11's own function in one PyTorch call, where this torch has it
        return torch.mm(abf, bbf, out_dtype=torch.float32)

    try:
        f32_out()
        f32_out_ms, f32_out_note = cuda_ms(f32_out, iters=10), None
    except (TypeError, RuntimeError) as e:
        f32_out_ms, f32_out_note = None, f"not timed: {type(e).__name__}: {str(e)[:160]}"
    bf16_kernels = device_kernels(lambda: int8_mm.mm_kernel(abf, bbf))
    results.append(dict(
        name="mm_bf16", tpu_id="K11", source="quickvc_tpu_torch/csrc/int8_mm.cu",
        replaces="scripts/int8_matmul_probe.py:85", shape=[[m, kk], [kk, n]],
        **compare(int8_mm.mm_kernel(abf, bbf), int8_mm.mm_reference(abf, bbf), 2e-3, 1e-4),
        tile=int8_mm.DEFAULT_TILE, device_kernels=bf16_kernels,
        pre_pass_launched=any("transpose_kernel" in k for k in bf16_kernels),
        **turns(lambda: int8_mm.mm_kernel(abf, bbf), lambda: torch.matmul(abf, bbf), iters=10),
        library_f32_out_ms=f32_out_ms, library_f32_out_note=f32_out_note,
        plain_ms=cuda_ms(lambda: int8_mm.mm_reference(abf, bbf), iters=5, warmup=1),
        bound_ops_ms=ops / BF16_FLOPS * 1e3,
        bound_bytes_ms=(2 * (m * kk + kk * n) + 4 * m * n) / HBM_BYTES * 1e3))
    return results


# ---------------------------------------------------------------------------
# phase 2: the conversion CLI end to end


def make_inputs(tmp: str, rng: np.random.Generator, hpfile: str):
    """Seeded checkpoints at the width of ``hpfile``, synthetic wavs and
    convert.txt under tmp."""
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.data.audio_io import write_wav
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import init_random_

    cfg = load_config(hpfile)
    net_g = init_random_(SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model), SEED)
    hubert = init_random_(HubertSoft(), SEED + 1)
    ptfile, hubert_pt = os.path.join(tmp, "G_0.pth"), os.path.join(tmp, "hubert-soft.pt")
    torch.save({"model": net_g.state_dict(), "iteration": 0}, ptfile)
    torch.save({"hubert": hubert.state_dict()}, hubert_pt)
    targets = []
    for i, sec in enumerate(TARGET_SECONDS):
        path = os.path.join(tmp, f"tgt{i}.wav")
        write_wav(path, synth_voice(sec, TARGET_SR, rng), TARGET_SR)
        targets.append(path)
    lines, n_frames = [], {}
    for i, sec in enumerate(SOURCE_SECONDS):
        path = os.path.join(tmp, f"src{i}.wav")
        wav = synth_voice(sec, SR, rng)
        write_wav(path, wav, SR)
        lines.append(f"pair{i}|{path}|{targets[i % len(targets)]}")
        n_frames[f"pair{i}"] = len(wav) // 320
    txt = os.path.join(tmp, "convert.txt")
    with open(txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    return cfg, net_g, hubert, [hpfile, ptfile, hubert_pt, txt], n_frames


def run_convert(files, outdir: str, device: str = "cuda") -> dict:
    from quickvc_tpu_torch import convert

    hpfile, ptfile, hubert_pt, txt = files
    return convert.main(["--hpfile", hpfile, "--ptfile", ptfile, "--hubert", hubert_pt,
                         "--txtpath", txt, "--outdir", outdir, "--device", device,
                         "--batch", str(BATCH)])


def check_outputs(summary: dict, n_frames: dict) -> None:
    from quickvc_tpu_torch.data.audio_io import read_wav

    require(summary["pairs"] == len(n_frames), "every pair converted")
    for path, _ in summary["outputs"]:
        wav, sr = read_wav(path)
        title = os.path.splitext(os.path.basename(path))[0]
        require(sr == SR and wav.dtype == np.float32, f"{title}: float32 wav at {SR} Hz")
        require(len(wav) == n_frames[title] * 320, f"{title}: length n_frames*320")
        require(bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
                f"{title}: finite, non-silent samples")


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def profile_span(run, span: str) -> dict:
    """Run ``run()`` under torch.profiler: device time by kernel, and the
    device's busy share of the one ``span`` (a ``record_function`` of the
    program) in the same trace: the union of kernel intervals inside the
    span over the span. The profiler's own host overhead lengthens the span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0 and e.key != span]
    kernels = [e for e in dev_events if not e.key.startswith(("Memcpy", "Memset"))]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]

    events = prof.events()
    spans = [e for e in events if e.name == span and e.device_type != cuda]
    require(len(spans) == 1, f"one {span} span in the trace, found {len(spans)}")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    kernel_iv = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and e.name != span
                 and not e.name.startswith(("Memcpy", "Memset"))]
    copy_iv = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == cuda and e.name.startswith("Memcpy")]
    busy_us = union_us(kernel_iv, lo, hi)
    require(hi > lo and busy_us > 0, f"device kernels ran inside the {span} span")
    return {
        "device_kernel_ms": total_ms,
        "memcpy_ms": sum(e.self_device_time_total for e in dev_events
                         if e.key.startswith("Memcpy")) / 1e3,
        "span_ms": (hi - lo) / 1e3,
        "kernel_busy_ms_in_span": busy_us / 1e3,
        "memcpy_busy_ms_in_span": union_us(copy_iv, lo, hi) / 1e3,
        "kernel_busy_share_of_span": busy_us / (hi - lo),
        "port_kernels_ms": {o: sum(e.self_device_time_total for e in kernels if o in e.key) / 1e3
                            for o in DEVICE_FUNCTIONS},
        "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in top],
    }


# ---------------------------------------------------------------------------
# phase 3: the path on the card against the CPU plain path


def check_against_cpu(cfg, net_g, hubert, rng: np.random.Generator) -> dict:
    from quickvc_tpu_torch.models.encoders import embed_utterance
    from quickvc_tpu_torch.ops.fused_mel import wave_to_mel

    src = torch.from_numpy(synth_voice(1.0, SR, rng)[None])
    tgt = torch.from_numpy(synth_voice(3.0, SR, rng)[None])
    d = cfg.data

    def path(dev):
        with torch.inference_mode():
            h, g_net = hubert.to(dev), net_g.to(dev)
            units = h.units(src.to(dev))
            mel = wave_to_mel(tgt.to(dev), SR, d.filter_length, d.hop_length,
                              d.win_length, d.n_mel_channels, d.mel_fmin, d.mel_fmax)
            g = embed_utterance(g_net.enc_spk, mel)
            wave = g_net.infer(units.transpose(1, 2), g, noise_scale=0.0)
            return units.cpu(), g.cpu(), wave.cpu()

    ref = path(torch.device("cpu"))
    ours = path(torch.device("cuda"))
    units_cmp = compare(ours[0], ref[0], 1e-4, 1e-3)
    g_cmp = compare(ours[1], ref[1], 1e-4, 1e-3)
    wave_err = float((ours[2] - ref[2]).abs().max() / ref[2].abs().max())
    out = {"units": units_cmp, "d_vector": g_cmp, "wave_max_abs_over_peak": wave_err,
           "wave_shape": list(ours[2].shape)}
    print("cpu_reference_check " + json.dumps(out))
    require(units_cmp["within_tol"], "units on the card match the CPU path")
    require(g_cmp["within_tol"], "d-vector on the card matches the CPU path")
    require(wave_err <= 1e-3, "wave on the card matches the CPU path (1e-3 x peak)")
    return out


# ---------------------------------------------------------------------------
# phase 4: the training CLI end to end


def make_corpus(tmp: str, rng: np.random.Generator) -> str:
    """Seeded s16 wavs of 12.5-13.5 s and three held-out ones of EVAL_SECONDS,
    each with a (frames, 256) unit .npy sibling, and a full-width float32
    compact-transfer config for them; returns the config's path."""
    from scipy.io import wavfile

    root = os.path.join(tmp, "corpus")
    os.makedirs(root)

    def write(name: str, seconds: float) -> str:
        wav = synth_voice(seconds, SR, rng)
        path = os.path.join(root, f"{name}.wav")
        wavfile.write(path, SR, np.round(wav * 32767).astype(np.int16))
        np.save(os.path.join(root, f"{name}.npy"),
                (0.5 * rng.standard_normal((len(wav) // 320, 256))).astype(np.float32))
        return path

    lists = {"train": [write(f"utt{i}", 12.5 + i / TRAIN_UTTERANCES)
                       for i in range(TRAIN_UTTERANCES)],
             "eval": [write(f"eval{i}", sec) for i, sec in enumerate(EVAL_SECONDS)]}
    for name, paths in lists.items():
        with open(os.path.join(tmp, f"{name}.txt"), "w") as f:
            f.write("\n".join(paths) + "\n")
    with open(os.path.join(ROOT, "configs", "quickvc.json")) as f:
        cfg = json.load(f)
    cfg["train"].update(precision="f32", batch_size=TRAIN_BATCH, max_speclen=512,
                        transfer="compact", log_interval=1, eval_interval=EVAL_INTERVAL,
                        loader_workers=4, segment_size=SEGMENT)
    cfg["data"]["training_files"] = os.path.join(tmp, "train.txt")
    cfg["data"]["validation_files"] = os.path.join(tmp, "eval.txt")
    hpfile = os.path.join(tmp, "train_config.json")
    with open(hpfile, "w") as f:
        json.dump(cfg, f)
    return hpfile


def run_train(hpfile: str, root: str, max_steps: int) -> dict:
    from quickvc_tpu_torch.train import loop

    return loop.main(["-c", hpfile, "-m", "smoke", "-mr", root, "--max-steps", str(max_steps),
                      "--device", "cuda"])


def _crc32c_table() -> list[int]:
    table = []
    for byte in range(256):
        c = byte
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 * (c & 1))
        table.append(c)
    return table


CRC32C_TABLE = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _fields(buf: bytes):
    """(field number, wire type, value) of one protobuf message."""
    i = 0

    def varint():
        nonlocal i
        n = shift = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n
    while i < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            yield field, wire, varint()
        elif wire == 1:
            yield field, wire, buf[i : i + 8]
            i += 8
        elif wire == 5:
            yield field, wire, buf[i : i + 4]
            i += 4
        elif wire == 2:
            n = varint()
            yield field, wire, buf[i : i + n]
            i += n
        else:
            raise CheckFailed(f"protobuf wire type {wire} in an event")


def read_events(log_dir: str) -> dict:
    """Every event file in ``log_dir``: each TFRecord's two masked CRC-32Cs
    checked; returns {"records", "file_version", "tags": {tag: [kind, sorted
    steps]}} (kind: scalar, image, audio, histogram)."""
    import struct

    files = sorted(n for n in os.listdir(log_dir) if n.startswith("events.out.tfevents."))
    require(bool(files), f"event files in {log_dir}")
    kinds = {2: "scalar", 4: "image", 5: "histogram", 6: "audio"}
    out = {"files": len(files), "records": 0, "file_version": [], "tags": {}}
    for name in files:
        with open(os.path.join(log_dir, name), "rb") as f:
            raw = f.read()
        i = 0
        while i < len(raw):
            head = raw[i : i + 8]
            n = struct.unpack("<Q", head)[0]
            crc_head, = struct.unpack("<I", raw[i + 8 : i + 12])
            data = raw[i + 12 : i + 12 + n]
            crc_data, = struct.unpack("<I", raw[i + 12 + n : i + 16 + n])
            require(crc_head == masked_crc32c(head) and crc_data == masked_crc32c(data),
                    f"{name}: record at byte {i} fails its CRC-32C")
            i += 16 + n
            out["records"] += 1
            step = 0
            for field, _, value in _fields(data):
                if field == 2:
                    step = value
                elif field == 3:
                    out["file_version"].append(value.decode())
                elif field == 5:
                    for _, _, v in _fields(value):            # Summary.value
                        parts = {f: x for f, _, x in _fields(v)}
                        tag = parts[1].decode()
                        kind = next(kinds[f] for f in kinds if f in parts)
                        rec = out["tags"].setdefault(tag, [kind, []])
                        rec[1].append(step)
        require(i == len(raw), f"{name}: ends on a record boundary")
    for rec in out["tags"].values():
        rec[1] = sorted(set(rec[1]))
    return out


class RecordingWriter:
    """The trainer's Summarizer interface, keeping what ``evaluate`` writes."""

    def __init__(self):
        self.scalar, self.audio = {}, {}

    def scalars(self, step, values):
        self.scalar.update({k: float(v) for k, v in values.items()})

    def images(self, step, values):
        pass

    def audios(self, step, values, sr):
        self.audio.update({k: np.asarray(v, np.float32).reshape(-1) for k, v in values.items()})

    def flush(self):
        pass


def check_eval_against_cpu(hpfile: str, g_path: str) -> dict:
    """The trainer's ``evaluate`` with the trained generator on the card (K1,
    K3) and on the CPU (their plain versions): the four eval/* scalars
    (mel_l1 within 2e-3, the similarities and margin within 1e-4) and the
    generated waves (1e-3 x peak)."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.data.dataset import UnitAudioSpecDataset
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.train.loop import evaluate
    from quickvc_tpu_torch.train.step import mel_basis
    from quickvc_tpu_torch.utils.weights import load_generator

    cfg = load_config(hpfile)
    eval_ds = UnitAudioSpecDataset("eval", cfg)
    writers, seconds = {}, {}
    for name in ("cpu", "cuda"):
        dev = torch.device(name)
        with torch.device("meta"):
            net = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
        load_generator(g_path, net)
        net = net.to(dev).train()
        writers[name] = RecordingWriter()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        evaluate(TRAIN_STEPS, cfg, net, eval_ds, mel_basis(cfg, dev), writers[name])
        seconds[name] = time.perf_counter() - t0
        if name == "cuda":
            launches = ops.launch_counts()
    ref, ours = writers["cpu"], writers["cuda"]
    tol = {"eval/mel_l1": 2e-3, "eval/spk_sim": 1e-4, "eval/vc_spk_sim": 1e-4,
           "eval/vc_spk_margin": 1e-4}
    scalars = {k: {"card": ours.scalar[k], "cpu": ref.scalar[k],
                   "abs_err": abs(ours.scalar[k] - ref.scalar[k]), "atol": tol[k]}
               for k in tol}
    waves = {k: float(np.abs(ours.audio[k] - v).max() / np.abs(v).max())
             for k, v in ref.audio.items() if not k.startswith("gt/")}
    n = len(EVAL_SECONDS)
    expected = {k: 0 for k in launches} | {"wave_to_mel": 2 * n, "polar_inverse_stft": 2 * n}
    out = {"items": n, "scalars": scalars, "waves_max_abs_over_peak": waves,
           "wave_names": sorted(waves), "seconds_cpu": seconds["cpu"],
           "seconds_card": seconds["cuda"], "launches": launches,
           "expected_launches": expected}
    print("eval_cpu_reference_check " + json.dumps(out))
    require(set(ours.scalar) == set(ref.scalar) == set(tol), "eval writes the four eval/* scalars")
    require(all(v["abs_err"] <= v["atol"] for v in scalars.values()),
            "eval scalars on the card match the CPU path")
    require(sorted(waves) == sorted([f"gen/audio_{i}" for i in range(n)] + ["vc/audio_0"]),
            "eval writes gen/audio_* and vc/audio_0")
    require(max(waves.values()) <= 1e-3, "eval waves on the card match the CPU path (1e-3 x peak)")
    require(launches == expected, f"eval launches {launches} != {expected}")
    return out


def check_process_loader(hpfile: str) -> dict:
    """The first batches of the full-width corpus (one an epoch, epochs
    LOADER_CHECK_EPOCHS) from thread and from process workers (spawned,
    shared memory): equal arrays."""
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                                UnitAudioSpecDataset)

    cfg = load_config(hpfile)
    ds = UnitAudioSpecDataset("train", cfg, with_spec=False)
    sampler = BucketSampler(ds.lengths, cfg.train.batch_size, BUCKET_BOUNDARIES)
    got, seconds = {}, {}
    for mode in ("thread", "process"):
        loader = DataLoader(ds, sampler, cfg, num_workers=cfg.train.loader_workers,
                            seed=cfg.train.seed, mode=mode)
        got[mode] = []
        try:
            t0 = time.perf_counter()
            for epoch in LOADER_CHECK_EPOCHS:
                sampler.set_epoch(epoch)
                # a copy: a yielded process-mode batch lives in shared memory
                got[mode] += [{k: v.copy() for k, v in b.items()} for b in loader]
            seconds[mode] = time.perf_counter() - t0
        finally:
            loader.close()
    equal = len(got["thread"]) == len(got["process"]) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(got["thread"], got["process"]))
    out = {"epochs": list(LOADER_CHECK_EPOCHS), "batches": len(got["process"]),
           "shapes": {k: list(v.shape) for k, v in got["process"][0].items()},
           "equal": equal, "seconds": seconds}
    print("process_loader " + json.dumps(out))
    require(len(got["process"]) >= len(LOADER_CHECK_EPOCHS) and equal,
            "process-mode batches equal the thread loader's")
    return out


def check_training(tmp: str, rng: np.random.Generator, files, n_frames) -> dict:
    """7 steps of the trainer CLI with eval after updates 1 and 5, the event
    files read back; then one profiled resumed step, the eval on the card
    against the CPU, process-mode batches against thread ones, and a
    conversion with the trained generator."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.ops import fused_mel
    from quickvc_tpu_torch.train.state import build_models
    from quickvc_tpu_torch.train.step import STEP_SPAN
    from quickvc_tpu_torch.utils.weights import init_random_

    hpfile = make_corpus(tmp, rng)
    root = os.path.join(tmp, "logs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    summary = run_train(hpfile, root, TRAIN_STEPS)
    launches = ops.launch_counts()
    mel_routes = dict(fused_mel.STATS.routes)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_eval = 2 * len(EVAL_SECONDS)   # reconstruction and conversion of each item
    expected = {name: 0 for name in launches} | {"wave_to_spec_halo": TRAIN_STEPS,
                                                 "wave_to_mel": per_eval * EVALS,
                                                 "polar_inverse_stft": per_eval * EVALS}

    losses = summary["losses"]
    require(summary["steps"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
            f"{TRAIN_STEPS} training steps")
    require(all(np.isfinite(v) for step in losses for v in step.values()), "finite losses")
    require(not any(step["skipped"] for step in losses), "no update skipped by the guard")
    require([e["step"] for e in summary["evals"]] == list(range(0, TRAIN_STEPS, EVAL_INTERVAL)),
            f"eval after updates {[g + 1 for g in range(0, TRAIN_STEPS, EVAL_INTERVAL)]}")
    require(all(np.isfinite(v) for e in summary["evals"] for v in e.values()),
            "finite eval metrics")
    require(launches == expected, f"training launches {launches} != {expected}")
    require(mel_routes == {"fft": per_eval * EVALS},
            f"the eval's log-mels took routes {mel_routes}, not the FFT")

    # the weights moved from their seeded initialisation (create_train_state's seeds)
    cfg = load_config(hpfile)
    init_g, init_d = build_models(cfg)
    init_random_(init_g, cfg.train.seed)
    init_random_(init_d, cfg.train.seed + 1)
    moved = {}
    for kind, net in (("G", init_g), ("D", init_d)):
        trained = torch.load(os.path.join(root, "smoke", f"{kind}_{TRAIN_STEPS}.pth"),
                             weights_only=True)["model"]
        diffs = [float((trained[k] - v).abs().max()) for k, v in net.state_dict().items()
                 if k != "dec.updown_filter"]
        moved[kind] = {"tensors": len(diffs), "moved": sum(d > 0 for d in diffs),
                       "max_abs_change": max(diffs)}
        require(moved[kind]["moved"] > 0.9 * len(diffs), f"{kind} weights moved")

    timed = summary["step_seconds"][TRAIN_WARMUP:]
    step_s = float(np.mean(timed))
    eval_s = [e["seconds"] for e in summary["evals"]]
    out = {"steps": TRAIN_STEPS, "step_seconds": summary["step_seconds"],
           "timed_steps": len(timed), "mean_step_seconds": step_s,
           "segment_audio_s_per_wall_s": TRAIN_BATCH * SEGMENT / SR / step_s,
           "crop_audio_s_per_wall_s": TRAIN_BATCH * 512 * 320 / SR / step_s,
           "eval_steps": [e["step"] for e in summary["evals"]], "eval_seconds": eval_s,
           "log_seconds": summary["log_seconds"],
           "evals": summary["evals"],
           "losses_first": losses[0], "losses_last": losses[-1], "weights": moved,
           "peak_memory_gb": peak_gb, "launches": launches, "expected_launches": expected,
           "eval_launches": {"wave_to_mel": launches["wave_to_mel"],
                             "polar_inverse_stft": launches["polar_inverse_stft"]},
           "wave_to_mel_routes": mel_routes}
    print("train " + json.dumps(out))

    run_dir = os.path.join(root, "smoke")
    events = {"train": read_events(run_dir), "eval": read_events(os.path.join(run_dir, "eval"))}
    n = len(EVAL_SECONDS)
    want = {"train": {"scalar": ["loss/g/total", "loss/d/total", "loss/g/mel", "loss/g/kl",
                                 "loss/g/fm", "loss/g/gen", "time/step_p50", "time/step_p95",
                                 "time/step_max", "host/rss_gb"],
                      "image": ["slice/mel_org", "slice/mel_gen", "all/mel"]},
            "eval": {"scalar": ["eval/mel_l1", "eval/spk_sim", "eval/vc_spk_sim",
                                "eval/vc_spk_margin"],
                     "image": [f"{k}/mel_{i}" for k in ("gen", "gt") for i in range(n)],
                     "audio": [f"{k}/audio_{i}" for k in ("gen", "gt") for i in range(n)]
                     + ["vc/audio_0"]}}
    missing = [(run, tag, kind) for run, kinds in want.items() for kind, tags in kinds.items()
               for tag in tags if events[run]["tags"].get(tag, [None])[0] != kind]
    print("event_files " + json.dumps({run: {"files": e["files"], "records": e["records"],
                                             "file_version": e["file_version"],
                                             "tags": e["tags"]} for run, e in events.items()}))
    require(not missing, f"event files lack {missing}")
    require(events["eval"]["tags"]["eval/mel_l1"][1] == out["eval_steps"],
            "eval events at the eval steps")
    require(events["train"]["tags"]["loss/g/total"][1][:TRAIN_STEPS] == list(range(TRAIN_STEPS)),
            "a loss event at every logged step")

    prof = profile_span(lambda: run_train(hpfile, root, TRAIN_STEPS + 1), STEP_SPAN)
    print("train_profile " + json.dumps(prof))
    g_path = os.path.join(run_dir, f"G_{TRAIN_STEPS}.pth")
    out["eval_check"] = check_eval_against_cpu(hpfile, g_path)
    out["process_loader"] = check_process_loader(hpfile)

    # the trained generator converts (reference layout, strict load)
    conv = run_convert([hpfile, g_path, files[2], files[3]], os.path.join(tmp, "trained_out"))
    check_outputs(conv, n_frames)
    out["hpfile"] = hpfile
    return out


def check_training_bf16(tmp: str, f32: dict) -> dict:
    """The trainer CLI at ``precision: "bf16"`` on the same corpus and config
    (compact transfer, the units shipped as bf16), BF16_TRAIN_STEPS steps with
    eval after update 1: finite losses, no skipped update, K4 once a step, the
    speaker LSTM's forward kernel once a step (the three layers in one
    launch) and its backward kernel once a step (the same), K1 (FFT
    route) and K3 twice a held-out item in the float32 eval and nothing else,
    float32 parameters and AdamW moments in the checkpoints; the step
    walls and peak memory printed beside the float32 run's of this call."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.ops import fused_mel

    with open(f32["hpfile"]) as f:
        cfg = json.load(f)
    cfg["train"]["precision"] = "bf16"
    hpfile = os.path.join(tmp, "train_config_bf16.json")
    with open(hpfile, "w") as f:
        json.dump(cfg, f)
    root = os.path.join(tmp, "logs_bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    summary = run_train(hpfile, root, BF16_TRAIN_STEPS)
    launches = ops.launch_counts()
    mel_routes = dict(fused_mel.STATS.routes)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_eval = 2 * len(EVAL_SECONDS) * len(range(0, BF16_TRAIN_STEPS, EVAL_INTERVAL))
    # the speaker LSTM's three layers: one stack launch forward and one backward a step
    expected = {name: 0 for name in launches} | {"wave_to_spec_halo": BF16_TRAIN_STEPS,
                                                 "wave_to_mel": per_eval,
                                                 "polar_inverse_stft": per_eval,
                                                 "lstm_stack_bf16": BF16_TRAIN_STEPS,
                                                 "lstm_stack_bf16_backward": BF16_TRAIN_STEPS}
    dtypes = set()
    for kind in "GD":
        ckpt = torch.load(os.path.join(root, "smoke", f"{kind}_{BF16_TRAIN_STEPS}.pth"),
                          weights_only=True)
        dtypes |= {str(v.dtype) for v in ckpt["model"].values()}
        dtypes |= {str(v.dtype) for st in ckpt["optimizer"]["state"].values()
                   for v in st.values()}
    losses = summary["losses"]
    timed = summary["step_seconds"][TRAIN_WARMUP:]
    out = {"steps": summary["steps"], "step_seconds": summary["step_seconds"],
           "mean_step_seconds": float(np.mean(timed)),
           "f32_mean_step_seconds": f32["mean_step_seconds"],
           "peak_memory_gb": peak_gb, "f32_peak_memory_gb": f32["peak_memory_gb"],
           "eval_seconds": [e["seconds"] for e in summary["evals"]], "evals": summary["evals"],
           "losses_first": losses[0], "losses_last": losses[-1],
           "checkpoint_dtypes": sorted(dtypes), "launches": launches,
           "expected_launches": expected, "wave_to_mel_routes": mel_routes}
    print("train_bf16 " + json.dumps(out))
    require(summary["steps"] == BF16_TRAIN_STEPS == len(losses),
            f"{BF16_TRAIN_STEPS} bf16 training steps")
    require(all(np.isfinite(v) for step in losses for v in step.values()),
            "finite bf16 losses")
    require(not any(step["skipped"] for step in losses), "no bf16 update skipped by the guard")
    require([e["step"] for e in summary["evals"]] == [0], "one eval, after update 1")
    require(all(np.isfinite(v) for e in summary["evals"] for v in e.values()),
            "finite eval metrics of the bf16 run")
    require(launches == expected, f"bf16 training launches {launches} != {expected}")
    require(mel_routes == {"fft": per_eval}, f"the eval's log-mels took routes {mel_routes}")
    require(dtypes == {"torch.float32"}, f"bf16 checkpoints hold {dtypes}, not float32 only")
    return out


# ---------------------------------------------------------------------------
# phase 5: the discriminator's opt-in K5/K6 path


def check_disc_fused(dev: torch.device, rng: np.random.Generator) -> dict:
    """One D phase (paired forward + parameter gradients) of the full-width
    MPD at the training batch, with the fifth conv of each period
    discriminator on K5/K6, against the default (cuDNN) discriminator."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.losses import discriminator_loss
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.utils.weights import init_random_

    base = init_random_(MultiPeriodDiscriminator(), SEED + 2).to(dev)
    fused = MultiPeriodDiscriminator(fused_conv5=True).to(dev)
    fused.load_state_dict(base.state_dict())
    y, y_hat = (torch.from_numpy(np.stack([synth_voice(SEGMENT / SR + 1e-3, SR, rng)[:SEGMENT]
                                           for _ in range(TRAIN_BATCH)])[:, None]).to(dev)
                for _ in range(2))

    def d_phase(net):
        logits_r, logits_g, _, _ = net(y, y_hat, pair=True)
        loss = discriminator_loss(logits_r, logits_g)[0]
        return loss, torch.autograd.grad(loss, list(net.parameters()))

    d_phase(fused)  # cuDNN set-up
    d_phase(base)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    loss_f, grads_f = d_phase(fused)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    loss_b, grads_b = d_phase(base)
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))
                   for a, b in zip(grads_f, grads_b))
    expected = {name: 0 for name in launches} | {"conv5_lrelu": 10, "conv5_lrelu_dw": 5}
    out = {"batch": list(y.shape), "loss_fused": loss_f.item(), "loss_default": loss_b.item(),
           "grad_max_rel_err": grad_err, "launches": launches, "expected_launches": expected,
           "fused_d_phase_ms": cuda_ms(lambda: d_phase(fused), iters=5, warmup=1),
           "default_d_phase_ms": cuda_ms(lambda: d_phase(base), iters=5, warmup=1)}
    print("disc_fused_path " + json.dumps(out))
    require(launches == expected, f"fused D launches {launches} != {expected}")
    require(abs(out["loss_fused"] - out["loss_default"]) <= 2e-4 * abs(out["loss_default"]),
            "fused D loss matches the default D")
    require(grad_err < 2e-3, "fused D gradients match the default D")
    return out


def check_disc_fused_bf16(dev: torch.device) -> dict:
    """The same paired D phase on bf16 waves (the bf16 training step's D
    phase): the fused MPD (K5 bf16 10 times and K6 bf16 5 times, every one on
    the wgmma body, nothing else of the port) against the default cuDNN bf16
    MPD (both D phases' times printed side by side), relative to the
    default's bf16 error against its float32 D phase (PERF.md section 2):
    loss ``|fused - ref| <= max(2 |ref - ref_f32|, 4e-3 |ref_f32|)``, each
    gradient ``maxrel(fused, ref) <= max(2 maxrel(ref, ref_f32), 2e-2)``;
    every parameter and gradient float32. Its own seeds, and torch's
    generators restored after it."""
    with torch.random.fork_rng(devices=[dev]):
        return _check_disc_fused_bf16(dev, np.random.default_rng(SEED + 15))


def _check_disc_fused_bf16(dev: torch.device, rng: np.random.Generator) -> dict:
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.losses import discriminator_loss
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.utils.weights import init_random_

    bf = torch.bfloat16
    base = init_random_(MultiPeriodDiscriminator(), SEED + 15).to(dev)
    fused = MultiPeriodDiscriminator(fused_conv5=True).to(dev)
    fused.load_state_dict(base.state_dict())
    y, y_hat = (torch.from_numpy(np.stack([synth_voice(SEGMENT / SR + 1e-3, SR, rng)[:SEGMENT]
                                           for _ in range(TRAIN_BATCH)])[:, None]).to(dev)
                for _ in range(2))

    def d_phase(net, dtype):   # as train/step.py runs it: logits to float32
        logits_r, logits_g, _, _ = net(y.to(dtype), y_hat.to(dtype), pair=True)
        loss = discriminator_loss([z.float() for z in logits_r],
                                  [z.float() for z in logits_g])[0]
        return loss, torch.autograd.grad(loss, list(net.parameters()))

    d_phase(fused, bf)  # cuDNN set-up
    d_phase(base, bf)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    loss_f, grads_f = d_phase(fused, bf)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    loss_b, grads_b = d_phase(base, bf)
    loss_32, grads_32 = d_phase(base, torch.float32)

    def maxrel(a, b) -> float:
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp(min=1e-6))

    names = [name for name, _ in fused.named_parameters()]
    ratios = {name: maxrel(f, b) / max(2 * maxrel(b, b32), 2e-2)
              for name, f, b, b32 in zip(names, grads_f, grads_b, grads_32)}
    worst = max(ratios, key=ratios.get)
    loss_bound = max(2 * abs(loss_b.item() - loss_32.item()), 4e-3 * abs(loss_32.item()))
    float32 = all(p.dtype == torch.float32 for p in fused.parameters()) and all(
        g.dtype == torch.float32 for g in grads_f)
    # every fifth conv on the wgmma body: its counters read the same 10 and 5
    expected = {name: 0 for name in launches} | {"conv5_lrelu_bf16": 10,
                                                 "conv5_lrelu_dw_bf16": 5,
                                                 "conv5_lrelu_bf16_wgmma": 10,
                                                 "conv5_lrelu_dw_bf16_wgmma": 5}
    out = {"batch": list(y.shape), "loss_fused": loss_f.item(), "loss_default": loss_b.item(),
           "loss_default_f32": loss_32.item(), "loss_bound": loss_bound,
           "grad_worst": worst, "grad_worst_err_over_bound": ratios[worst],
           "params_and_grads_float32": float32, "launches": launches,
           "expected_launches": expected,
           "fused_d_phase_ms": cuda_ms(lambda: d_phase(fused, bf), iters=5, warmup=1),
           "default_d_phase_ms": cuda_ms(lambda: d_phase(base, bf), iters=5, warmup=1)}
    print("disc_fused_bf16_path " + json.dumps(out))
    require(launches == expected, f"fused bf16 D launches {launches} != {expected}")
    require(abs(out["loss_fused"] - out["loss_default"]) <= loss_bound,
            "fused bf16 D loss matches the default bf16 D")
    require(ratios[worst] <= 1.0, "fused bf16 D gradients match the default bf16 D")
    require(float32, "every parameter and gradient float32 after the bf16 D phase")
    return out


def run_disc_ab() -> dict:
    """The A/B script (``python -m quickvc_tpu_torch.scripts.disc_pallas_ab``)
    at its defaults through its entry point, on its own seeds with torch's
    generators restored after it: every line finite, K5 and K6 bf16 launched
    as each line's variant implies (the fused conv's forward once, its
    filter gradient K5 and K6 once each, ``pallas_l5``'s D gradient K5 twice
    and K6 once) and no K5/K6 bf16 launch elsewhere."""
    from quickvc_tpu_torch.scripts import disc_pallas_ab

    t0 = time.time()
    with torch.random.fork_rng(devices=[torch.device("cuda")]):
        lines = disc_pallas_ab.main([])
    implied = {"_fused_fwd": (1, 0), "_fused_grad": (1, 1), "_pallas_l5_grad": (2, 1)}
    bad = []
    for line in lines:
        k5, k6 = next((v for end, v in implied.items() if line["name"].endswith(end)), (0, 0))
        if not line["finite"] or line["launches"] != {"conv5_lrelu_bf16": k5,
                                                      "conv5_lrelu_dw_bf16": k6}:
            bad.append(line["name"])
    out = {"seconds": time.time() - t0, "lines": len(lines), "bad": bad,
           "ms": {line["name"]: line["ms"] for line in lines}}
    print("disc_ab " + json.dumps(out))
    require(len(lines) == 17 and not bad, f"A/B script lines {bad} off")
    return out


# ---------------------------------------------------------------------------
# phase 6: one training step on the card against the CPU plain path


def check_train_step_against_cpu(rng: np.random.Generator) -> dict:
    """A small config, the same weights, compact batch and draws on both, in
    float32 (losses rtol 2e-4, gradients 2e-3) and at ``precision: "bf16"``,
    held relative to the bf16 error of the CPU step against its float32 step
    (PERF.md section 2): losses ``|card - cpu| <= max(2 |cpu - cpu_f32|,
    4e-3 |cpu_f32|)``, each gradient ``maxrel(card, cpu) <= max(2
    maxrel(cpu, cpu_f32), 2e-2)``; every parameter float32 afterwards. The
    posterior noise is bf16-valued, so both precisions draw the same."""
    import copy

    from quickvc_tpu_torch.config import config_from_dict
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    def small(precision: str):
        return config_from_dict({
            "train": {"segment_size": 2560, "max_speclen": 32, "precision": precision,
                      "learning_rate": 1e-4, "disc_width": 0.25, "batch_size": 2},
            "model": {"inter_channels": 16, "hidden_channels": 16,
                      "upsample_initial_channel": 32, "gin_channels": 16,
                      "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
                      "enc_wn_layers": 2, "flow_wn_layers": 2, "n_flows": 2}})

    frames = 16
    wave = np.stack([synth_voice(1.0, SR, rng)[: frames * 320 + 960] for _ in range(2)])
    batch = {"unit": torch.from_numpy(rng.standard_normal((2, frames, 256)).astype(np.float32)),
             "wave_s16": torch.from_numpy(np.round(wave * 32767).astype(np.int16)),
             "n_take": torch.tensor([frames, frames - 5], dtype=torch.int32)}
    eps_q = torch.from_numpy(rng.standard_normal((2, 16, frames)).astype(np.float32))
    eps_q = eps_q.bfloat16().float()
    ids = torch.tensor([3, 8])
    base = create_train_state(small("f32"), torch.device("cpu"))
    results, params_f32 = {}, True
    for precision in ("f32", "bf16"):
        cfg = small(precision)
        for name in ("cpu", "cuda"):
            dev = torch.device(name)
            state = create_train_state(cfg, dev, copy.deepcopy(base.net_g),
                                       copy.deepcopy(base.net_d))
            # the CPU side on torch's native convolutions: oneDNN's float32 weight
            # gradients of the scale discriminator's first convolutions drift by
            # up to 3e-3 of their max, depending on the thread count
            with torch.backends.mkldnn.flags(enabled=False):
                results[precision, name] = train_step(
                    state, {k: v.to(dev) for k, v in batch.items()}, mel_basis(cfg, dev),
                    eps_q=eps_q.to(dev), ids_slice=ids, debug_grads=True)
            params_f32 &= all(p.dtype == torch.float32 for net in (state.net_g, state.net_d)
                              for p in net.parameters())
    loss_keys = ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl",
                 "loss/g/total")

    def maxrel(a, b) -> float:
        return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max().clamp(min=1e-6))

    ref, ours = results["f32", "cpu"], results["f32", "cuda"]
    losses = {k: [float(ours[k]), float(ref[k])] for k in loss_keys}
    grad_err = {which: max(maxrel(ours[f"debug/{which}_grads"][k], v)
                           for k, v in ref[f"debug/{which}_grads"].items())
                for which in ("d", "g")}
    ref16, ours16 = results["bf16", "cpu"], results["bf16", "cuda"]
    losses16, loss16_ok = {}, True
    for k in loss_keys:
        o, r, y = float(ours16[k]), float(ref16[k]), float(ref[k])
        bound = max(2 * abs(r - y), 4e-3 * abs(y))
        losses16[k] = {"card": o, "cpu": r, "cpu_f32": y, "err": abs(o - r), "bound": bound}
        loss16_ok &= abs(o - r) <= bound
    grads16, grad16_ok = {}, True
    for which in ("d", "g"):
        ratios = {}
        for k, r in ref16[f"debug/{which}_grads"].items():
            err = maxrel(ours16[f"debug/{which}_grads"][k], r)
            bound = max(2 * maxrel(r, ref[f"debug/{which}_grads"][k]), 2e-2)
            ratios[k] = err / bound
            grad16_ok &= err <= bound
        worst = max(ratios, key=ratios.get)
        grads16[which] = {"tensors": len(ratios), "worst": worst,
                          "worst_err_over_bound": ratios[worst]}
    out = {"losses_card_cpu": losses, "grad_max_rel_err": grad_err,
           "bf16": {"losses": losses16, "grads": grads16, "params_float32": params_f32}}
    print("train_cpu_reference_check " + json.dumps(out))
    require(all(abs(a - b) <= 1e-5 + 2e-4 * abs(b) for a, b in losses.values()),
            "training losses on the card match the CPU path")
    require(max(grad_err.values()) < 2e-3, "training gradients on the card match the CPU path")
    require(loss16_ok, "bf16 training losses on the card match the CPU path")
    require(grad16_ok, "bf16 training gradients on the card match the CPU path")
    require(params_f32, "every parameter stays float32 after a bf16 step")
    return out


def lstm_backward_accuracy(dhs, w_ih, w_hh, act: torch.Tensor, c: torch.Tensor) -> dict:
    """The backward stack kernel's accuracy on a bf16 LSTM stack's act and c
    (L, B, T, .), the W_ih of layers 1 .. L-1 and the W_hh of every layer,
    for each output gradient in ``dhs``: every layer's dgates from the stack
    (one launch), from the three one-layer launches (``lstm_backward_chain``,
    the schedule before the stack) and from the plain stack backward on the
    card, each against the same recurrence in float32 and in float64 on the
    same bf16-valued inputs (``lstm_stack_backward_reference``); and each
    layer alone, the stack's dgates against the plain backward on the dh the
    stack handed that layer, against the same witnesses. Held
    (``within_ratio``): the stack's max and rms errors at most
    BF16_F32_RATIO times the plain version's, every layer, draw and witness.
    Measured beside them: max|stack - plain| and max|three launches -
    plain| with the max|delta| part of PERF.md section 2's bf16 gate, and on
    the first draw max|plain on the host - plain on the card|, one plain
    chain whose float32 sums run in two orders."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr
    from quickvc_tpu_torch.scripts.kernel_times import lstm_backward_chain

    def err(z: torch.Tensor, ref: torch.Tensor) -> dict:
        d = z.double() - ref.double()
        return {"max": float(d.abs().max()), "rms": float(d.square().mean().sqrt())}

    def diff(z: torch.Tensor, ref: torch.Tensor) -> float:
        return float((z.float() - ref.float()).abs().max())

    def held(errors: dict) -> bool:
        return all(errors["stack"][k] <= BF16_F32_RATIO * errors["plain"][k]
                   for k in ("max", "rms"))

    layers, witnesses, draws, ok = len(w_hh), (torch.float32, torch.float64), [], True
    for i, dh in enumerate(dhs):
        ours, dh_mid = lr.lstm_stack_backward_kernel(dh, w_ih, w_hh, act, c, return_dh=True)
        chain = lstm_backward_chain(dh, w_ih, w_hh, act, c)
        plain = lr.lstm_stack_backward_reference(dh, w_ih, w_hh, act, c)
        refs = {dt: lr.lstm_stack_backward_reference(dh.to(dt), [w.to(dt) for w in w_ih],
                                                     [w.to(dt) for w in w_hh], act.to(dt),
                                                     c.to(dt)) for dt in witnesses}
        draw = {}
        for layer in range(layers):
            peak = float(plain[layer].float().abs().max())
            dh_l = dh if layer + 1 == layers else dh_mid[layer]
            alone = lr.lstm_backward_reference(dh_l, w_hh[layer], act[layer], c[layer])
            row = {"stack_minus_plain": diff(ours[layer], plain[layer]),
                   "three_launches_minus_plain": diff(chain[layer], plain[layer]),
                   "gate_max_abs": max(BF16_GATE * peak, 2 * bf16_ulp(peak)),
                   "alone_minus_plain": diff(ours[layer], alone)}
            for dt in witnesses:
                name = str(dt).removeprefix("torch.")
                stack_err = {"stack": err(ours[layer], refs[dt][layer]),
                             "three_launches": err(chain[layer], refs[dt][layer]),
                             "plain": err(plain[layer], refs[dt][layer])}
                one = lr.lstm_backward_reference(dh_l.to(dt), w_hh[layer].to(dt),
                                                 act[layer].to(dt), c[layer].to(dt))
                alone_err = {"stack": err(ours[layer], one), "plain": err(alone, one)}
                ok = ok and held(stack_err) and held(alone_err)
                row[f"err_{name}"], row[f"alone_err_{name}"] = stack_err, alone_err
            draw[f"dgates_l{layer}"] = row
        if i == 0:
            host = lr.lstm_stack_backward_reference(dh.cpu(), [w.cpu() for w in w_ih],
                                                    [w.cpu() for w in w_hh], act.cpu(), c.cpu())
            draw["host_plain_minus_card_plain"] = [diff(host[layer], plain[layer].cpu())
                                                   for layer in range(layers)]
        draws.append(draw)
        del ours, dh_mid, chain, plain, refs
    return {"draws": draws, "within_ratio": ok}


def check_speaker_lstm_bf16() -> tuple[dict, list[dict]]:
    """The bf16 speaker encoder at full width on a training-shaped mel (32,
    512, 80): forward, then the backward of a seeded scalar of the
    d-vectors, its LSTM on the kernels (one launch of the stack kernel for
    the three layers' forward, one launch of the backward stack kernel for
    their backward) against the plain versions on the card
    (``ops/lstm_recurrence.py``) by ``bf16_gate``, the float32 ``nn.LSTM``
    on the same bf16-valued mel the yardstick, for the d-vectors and every
    ``enc_spk.lstm`` gradient; two kernel runs bit-equal. Then the stack
    kernel alone on the encoder's three layers (h, act and c of every layer
    against the plain stack; one layer alone against the plain layer),
    timed (CUDA events and device time) from the mel, layer 0's projection
    included, in turns with cuDNN's 3-layer bf16 ``nn.LSTM`` forward,
    beside the plain stack and the three per-layer launches with their
    projections; and the backward stack kernel on the stack's act and c
    (each layer's dgates bit-equal to the one-layer kernel on the dh the
    stack handed that layer, the top's dh_out, each handed-down dh within a
    bf16 ulp of the float32 product rounded once, the one-layer kernel
    within the bf16 gate of the plain backward; two launches bit-equal;
    each layer against the plain backward on its dh, and the whole stack
    against the plain stack backward beside the three one-layer launches'
    against it, reported), timed in turns with the three
    layers' backward one launch each (the torch product between) and with
    cuDNN's 3-layer bf16 backward alone, beside the plain stack backward:
    the two ``kernels`` rows, whose ``library_ms`` is cuDNN's device time.
    Its own seeds, torch's generators restored after it."""
    with torch.random.fork_rng(devices=[torch.device("cuda")]):
        return _check_speaker_lstm_bf16(np.random.default_rng(SEED + 15))


def _check_speaker_lstm_bf16(rng: np.random.Generator) -> tuple[dict, list[dict]]:
    import contextlib

    from quickvc_tpu_torch.models.encoders import SpeakerEncoder
    from quickvc_tpu_torch.ops import lstm_recurrence as lr
    from quickvc_tpu_torch.scripts.bf16_step_gate import card_lstm
    from quickvc_tpu_torch.scripts.kernel_times import (cudnn_backward, cudnn_lstm,
                                                        lstm_backward_chain)
    from quickvc_tpu_torch.utils.weights import init_random_

    dev, bf = torch.device("cuda"), torch.bfloat16
    enc = init_random_(SpeakerEncoder(), SEED + 5).to(dev)
    b, t_len, hsz = TRAIN_BATCH, 512, enc.lstm.hidden_size
    layers = enc.lstm.num_layers
    mel = torch.from_numpy(rng.standard_normal((b, t_len, 80)).astype(np.float32)).to(dev).to(bf)
    weigh = torch.from_numpy(rng.standard_normal((b, 256)).astype(np.float32)).to(dev)

    def run(mode: str):
        """d-vectors and LSTM gradients: "kernel" (the port), "plain" (the
        plain versions on the card), "f32" (nn.LSTM on the float32 mel)."""
        enc.zero_grad(set_to_none=True)
        with card_lstm("recurrence") if mode == "plain" else contextlib.nullcontext():
            d = enc(mel.float() if mode == "f32" else mel)
            (d.float() * weigh).sum().backward()
        torch.cuda.synchronize()
        return d.detach(), {k: v.grad.detach().clone() for k, v in enc.lstm.named_parameters()}

    torch.cuda.synchronize()
    before = (lr.STATS.launches, lr.BACKWARD_STATS.launches)
    t0 = time.perf_counter()
    d_k, g_k = run("kernel")
    seconds = time.perf_counter() - t0
    launches = (lr.STATS.launches - before[0], lr.BACKWARD_STATS.launches - before[1])
    d_k2, g_k2 = run("kernel")
    (d_p, g_p), (d_32, g_32) = run("plain"), run("f32")
    deterministic = bool(torch.equal(d_k, d_k2)
                         and all(torch.equal(g_k[k], g_k2[k]) for k in g_k))
    gates = {"d_vectors": bf16_gate(d_k, d_p, d_32)} | {
        f"enc_spk.lstm.{k}": bf16_gate(g_k[k].to(bf), g_p[k].to(bf), g_32[k]) for k in g_k}

    # the stack kernel alone on the encoder's three layers
    w_ih, w_hh, bias = zip(*(tuple(z.detach() for z in enc._layer_weights(layer, bf))
                             for layer in range(layers)))
    xp = (mel @ w_ih[0].T + bias[0]).contiguous()
    stack = lr.lstm_stack_kernel(xp, w_ih[1:], bias[1:], w_hh)
    plain = lr.lstm_stack_reference(xp, w_ih[1:], bias[1:], w_hh)
    ref32 = lr.lstm_stack_reference(xp.float(), [w.float() for w in w_ih[1:]],
                                    [z.float() for z in bias[1:]], [w.float() for w in w_hh])
    stack_checks = {f"{out}_l{layer}": bf16_gate(k[layer], p[layer], r[layer])
                    for out, k, p, r in zip(("h", "act", "c"), stack, plain, ref32)
                    for layer in range(layers)}
    fwd = lr.lstm_forward_kernel(xp, w_hh[0])     # one layer: a stack of one
    fwd_plain = lr.lstm_forward_reference(xp, w_hh[0])
    fwd_32 = lr.lstm_forward_reference(xp.float(), w_hh[0].float())
    stack_checks |= {f"{out}_layer_alone": bf16_gate(k, p, r) for out, k, p, r
                     in zip(("h", "act", "c"), fwd, fwd_plain, fwd_32)}
    stack_same = all(torch.equal(a, z) for a, z in
                     zip(stack, lr.lstm_stack_kernel(xp, w_ih[1:], bias[1:], w_hh)))

    def layer_chain():
        """The three layers one launch each, their projections between."""
        outs, z = [], xp
        for layer in range(layers):
            outs.append(lr.lstm_forward_kernel(z, w_hh[layer]))
            if layer + 1 < layers:
                z = outs[-1][0] @ w_ih[layer + 1].T + bias[layer + 1]
        return outs

    chain = layer_chain()
    chain_equal = all(torch.equal(stack[i][layer], chain[layer][i])
                      for i in range(3) for layer in range(layers))

    # the backward stack kernel on the encoder's three layers, the stack's
    # act and c: each layer bit-equal to the one-layer kernel (the per-layer
    # kernel the stack replaced, bit for bit) on the dh the stack handed it
    # (dh_out for the top), each handed-down dh within a bf16 ulp of the
    # float32 product rounded once, the one-layer kernel held against the
    # plain backward by the bf16 gate as before, two launches bit-equal; its
    # accuracy on three draws of dh_out (lstm_backward_accuracy)
    dh = torch.from_numpy(rng.standard_normal((b, t_len, hsz)).astype(np.float32)).to(dev).to(bf)
    bwd, dh_mid = lr.lstm_stack_backward_kernel(dh, w_ih[1:], w_hh, stack[1], stack[2],
                                                return_dh=True)
    proj_ok, layers_equal = True, True
    for layer in range(layers):
        dh_l = dh if layer + 1 == layers else dh_mid[layer]
        layers_equal = layers_equal and bool(torch.equal(bwd[layer], lr.lstm_backward_kernel(
            dh_l, w_hh[layer], stack[1][layer], stack[2][layer])))
        if layer:   # one rounding of a float32 sum, in another order than torch's
            want = bwd[layer].float() @ w_ih[layer].float()
            scale = bwd[layer].float().abs() @ w_ih[layer].float().abs()
            got = dh_mid[layer - 1].float()
            ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()))) - 7)
            proj_ok = proj_ok and bool(((got - want).abs() <= ulp + 2.0 ** -16 * scale).all())
    bwd_checks = {}
    bwd_checks["dgates_layer_alone"] = bf16_gate(   # one layer: a stack of one
        lr.lstm_backward_kernel(dh, w_hh[0], fwd[1], fwd[2]),
        lr.lstm_backward_reference(dh, w_hh[0], fwd[1], fwd[2]),
        lr.lstm_backward_reference(dh.float(), w_hh[0].float(), fwd_32[1], fwd_32[2]))
    bwd_same = bool(torch.equal(bwd, lr.lstm_stack_backward_kernel(dh, w_ih[1:], w_hh, stack[1],
                                                                    stack[2])))
    del bwd, dh_mid
    more = np.random.default_rng(SEED + 16)   # two more draws, the phases' draws unchanged
    dhs = [dh] + [torch.from_numpy(more.standard_normal((b, t_len, hsz)).astype(np.float32))
                  .to(dev).to(bf) for _ in range(2)]
    accuracy = lstm_backward_accuracy(dhs, w_ih[1:], w_hh, stack[1], stack[2])

    # cuDNN's bf16 LSTM, three layers, on the same weights: its forward, and
    # its backward alone (the graph kept, the input and weight gradients)
    mel_in = mel.detach()
    cudnn3 = cudnn_lstm(w_ih, w_hh, bias)
    cudnn3_backward = cudnn_backward(cudnn3, mel_in, dh)

    def stack_forward():   # from the mel, as the encoder runs it
        return lr.lstm_stack_kernel(mel_in @ w_ih[0].T + bias[0], w_ih[1:], bias[1:], w_hh)

    def cudnn3_forward():
        return cudnn3(mel_in)[0]

    def stack_backward():
        return lr.lstm_stack_backward_kernel(dh, w_ih[1:], w_hh, stack[1], stack[2])

    def backward_chain():   # the three layers one launch each (the schedule before the stack)
        return lstm_backward_chain(dh, w_ih[1:], w_hh, stack[1], stack[2])

    # in turns: library, kernel, kernel, library
    with torch.no_grad():
        stack_t = turns(stack_forward, cudnn3_forward, iters=10)
        chain_ms = cuda_ms(layer_chain, iters=10)
        stack_plain_ms = cuda_ms(lambda: lr.lstm_stack_reference(xp, w_ih[1:], bias[1:], w_hh),
                                 iters=2, warmup=1)
        bwd_chain_t = turns(stack_backward, backward_chain, iters=10)
        bwd_plain_ms = cuda_ms(lambda: lr.lstm_stack_backward_reference(
            dh, w_ih[1:], w_hh, stack[1], stack[2]), iters=1, warmup=1)
    bwd_t = turns(stack_backward, cudnn3_backward, iters=10)
    plan = lr.lstm_stack_plan(b, hsz, layers)
    bplan = lr.lstm_stack_backward_plan(b, hsz, layers)
    n_rows, g4 = b * t_len, 4 * hsz
    product = 2 * n_rows * g4 * hsz  # one step product of a layer over the sequence
    common = dict(source="quickvc_tpu_torch/csrc/lstm_recurrence.cu",
                  replaces="quickvc_tpu/models/encoders.py:89")
    stack_merged = merge_checks(stack_checks)
    bwd_merged = merge_checks(bwd_checks)
    rows = [
        dict(name="lstm_stack_bf16", tpu_id=None, **common,
             shape=[[b, t_len, g4], [layers, g4, hsz]], layers=layers,
             **(stack_merged | {"within_tol": stack_merged["within_tol"] and stack_same}),
             deterministic=stack_same, equal_to_layer_chain=chain_equal, **stack_t,
             three_layer_chain_ms=chain_ms, serial_steps=plan.serial_steps(t_len),
             plan={"layers": plan.layers, "skew": plan.skew, "clusters": plan.clusters,
                   "chunk": plan.layer.chunk, "units": plan.layer.units},
             plain_ms=stack_plain_ms,
             library_note="cuDNN's 3-layer bf16 nn.LSTM forward, device time; both from the "
                          "mel, layer 0's projection included",
             # W_hh products of every layer, W_ih of the deeper ones
             bound_ops_ms=(2 * layers - 1) * product / BF16_FLOPS * 1e3,
             # xp0, the weights and biases in; every layer's h, c and act out (bf16)
             bound_bytes_ms=2 * (n_rows * g4 + (2 * layers - 1) * g4 * hsz + (layers - 1) * g4
                                 + layers * (2 * n_rows * hsz + n_rows * g4)) / HBM_BYTES * 1e3),
        dict(name="lstm_stack_bf16_backward", tpu_id=None, **common,
             shape=[[layers, b, t_len, g4], [layers, g4, hsz]], layers=layers,
             **(bwd_merged | {"within_tol": bwd_merged["within_tol"] and bwd_same and proj_ok
                              and layers_equal and accuracy["within_ratio"]}),
             deterministic=bwd_same, projections_within_ulp=proj_ok,
             layers_equal_one_layer_kernel=layers_equal, accuracy=accuracy,
             **bwd_t, serial_steps=bplan.serial_steps(t_len),
             plan={"layers": bplan.layers, "skew": bplan.skew, "clusters": bplan.clusters,
                   "chunk": bplan.layer.chunk, "units": bplan.layer.units,
                   "shared_bytes": bplan.shared_bytes(True)},
             three_layer_chain_ms=bwd_chain_t["library_ms"],
             three_layer_chain_device_ms=bwd_chain_t["library_device_ms"],
             chain_turns_ms=bwd_chain_t["ms"], chain_turns_device_ms=bwd_chain_t["device_ms"],
             plain_ms=bwd_plain_ms,
             library_note="cuDNN's 3-layer bf16 nn.LSTM backward alone (input and weight "
                          "gradients, the forward's graph kept), device time; "
                          "three_layer_chain_*: the three layers one launch each",
             # W_hh products of every layer, W_ih of the upper ones
             bound_ops_ms=(2 * layers - 1) * product / BF16_FLOPS * 1e3,
             # dh_out, the weights, every layer's act and c in; dgates out (bf16)
             bound_bytes_ms=2 * (n_rows * hsz + (2 * layers - 1) * g4 * hsz
                                 + layers * (2 * n_rows * g4 + n_rows * hsz)) / HBM_BYTES * 1e3)]
    for r, t in zip(rows, (stack_t, bwd_t)):
        # the host takes longer to enqueue a cuDNN LSTM call than the card
        # takes to run it (PERF.md section 6): the line holds the kernels
        # against cuDNN's device time, its events time beside it
        r["library_ms"], r["library_events_ms"] = t["library_device_ms"], t["library_ms"]
    # CUDA events: torch.profiler has dropped these cluster kernels' records
    # in a long process (read 0 or half their time)
    out = {"shape": [b, t_len, 80], "hidden": hsz, "gates": gates,
           "deterministic": deterministic, "first_run_seconds": seconds,
           "launches_forward_backward": launches, "backward_checks": bwd_checks,
           "three_layers_forward_ms": stack_t["ms"], "three_layer_chain_ms": chain_ms,
           "three_layers_backward": bwd_t, "three_layer_backward_chain": bwd_chain_t}
    print("speaker_lstm_bf16_check " + json.dumps(out))
    bad = [k for k, g in gates.items() if not g["within_tol"]]
    require(not bad, f"the bf16 speaker LSTM's kernels against their plain versions: {bad}")
    require(deterministic, "two bf16 speaker-encoder runs on the kernels bit-equal")
    require(launches == (1, 1), f"the encoder's LSTM launched {launches}, not one forward "
                                f"and one backward stack launch")
    return out, rows


def check_lstm_stack_residency() -> dict:
    """The forward and backward stack kernels at a batch whose clusters the
    card cannot hold at once (three layers of 640 rows: 60 clusters of 8
    CTAs forward, 120 backward): each wrapper must raise RuntimeError naming
    the clusters needed and held, and launch nothing; a launch that could
    wait forever never starts."""
    from quickvc_tpu_torch.ops import _cuda
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    dev, bf = torch.device("cuda"), torch.bfloat16
    b, t_len, hsz, layers = 32 * 20, 64, 256, 3
    plan = lr.lstm_stack_plan(b, hsz, layers)
    bplan = lr.lstm_stack_backward_plan(b, hsz, layers)
    held = _cuda.library().qvc_lstm_stack_max_clusters(b, t_len, hsz, plan.layer.chunk, layers,
                                                       plan.skew)
    held_b = _cuda.library().qvc_lstm_stack_backward_max_clusters(b, t_len, hsz,
                                                                  bplan.layer.chunk, layers)
    xp = torch.zeros(b, t_len, 4 * hsz, device=dev, dtype=bf)
    w = torch.zeros(4 * hsz, hsz, device=dev, dtype=bf)
    act = torch.zeros(layers, b, t_len, 4 * hsz, device=dev, dtype=bf)
    c = torch.zeros(layers, b, t_len, hsz, device=dev, dtype=bf)
    before = (lr.STATS.launches, lr.BACKWARD_STATS.launches)
    messages = []
    for launch in (lambda: lr.lstm_stack_kernel(xp, [w] * (layers - 1),
                                                [w[:, 0]] * (layers - 1), [w] * layers),
                   lambda: lr.lstm_stack_backward_kernel(c[0], [w] * (layers - 1), [w] * layers,
                                                         act, c)):
        try:
            launch()
            messages.append(None)
        except RuntimeError as e:
            messages.append(str(e))
    torch.cuda.synchronize()
    out = {"batch": b, "layers": layers, "clusters_needed": [plan.clusters, bplan.clusters],
           "clusters_held": [held, held_b], "errors": messages,
           "launched": [lr.STATS.launches - before[0], lr.BACKWARD_STATS.launches - before[1]]}
    print("lstm_stack_residency " + json.dumps(out))
    require(all(m is not None and str(n) in m and str(h) in m and h < n
                for m, n, h in zip(messages, out["clusters_needed"], out["clusters_held"]))
            and out["launched"] == [0, 0],
            f"the stack kernels at {out['clusters_needed']} clusters: {out}")
    return out


def run_bf16_step_gate() -> dict:
    """The bf16 step gate of ``check_train_step_against_cpu`` on five other
    draws, ``quickvc_tpu_torch.scripts.bf16_step_gate`` seeds 1-5 with the
    card's speaker LSTM on its kernels: every D and G ratio at most 1."""
    from quickvc_tpu_torch.scripts import bf16_step_gate

    t0 = time.time()
    lines = [z for z in bf16_step_gate.main(["--seeds", "1", "2", "3", "4", "5"]) if "seed" in z]
    ratios = {z["seed"]: {w: z[w]["worst_err_over_bound"] for w in "dg"} for z in lines}
    out = {"seeds": ratios, "seconds": time.time() - t0}
    print("bf16_step_gate_seeds " + json.dumps(out))
    require(all(v <= 1.0 for r in ratios.values() for v in r.values()),
            f"the bf16 step gate on seeds 1-5: {ratios}")
    return out


# ---------------------------------------------------------------------------
# phase 7: offline unit encoding, the encode CLI end to end


def run_encode(root: str, out: str, hubert_pt: str, front: str, fused: bool,
               device: str = "cuda", batch: int = ENCODE_BATCH) -> dict:
    from quickvc_tpu_torch import encode

    return encode.main(["soft", root, out, "--hubert", hubert_pt, "--batch", str(batch),
                        "--hubert-front", front, "--device", device], fused_layer=fused)


def load_units(summary: dict, root_out: str) -> dict[str, np.ndarray]:
    return {os.path.relpath(str(path), root_out): np.load(path) for path in summary["outputs"]}


def check_encoding(tmp: str, rng: np.random.Generator, hubert_pt: str) -> dict:
    """The encode CLI over 32 synthetic wavs in each of ENCODE_RUNS, the
    counters zeroed just before each run and read just after; each run's
    units against the default front's; one profiled run of each."""
    from quickvc_tpu_torch import encode, ops
    from quickvc_tpu_torch.data.audio_io import write_wav

    root = os.path.join(tmp, "encode_wavs")
    os.makedirs(root)
    n_frames = {}
    for i, sec in enumerate(ENCODE_SECONDS):
        wav = synth_voice(sec, SR, rng)
        write_wav(os.path.join(root, f"utt{i:02d}.wav"), wav, SR)
        n_frames[f"utt{i:02d}.npy"] = len(wav) // 320
    n_batches = len({int(np.ceil(sec)) for sec in ENCODE_SECONDS})   # one full batch a bucket
    zero = {name: 0 for name in ops.launch_counts()}
    expected = {
        "faststats": zero | {"attention_packed": 12 * n_batches},
        "pallas": zero | {"extractor_front": n_batches, "attention_packed": 12 * n_batches},
        "pallas_fused_layer": zero | {"extractor_front": n_batches,
                                      "transformer_layer": 12 * n_batches}}
    for name, front, fused in ENCODE_RUNS:   # cuDNN set-up, allocator
        run_encode(root, os.path.join(tmp, f"enc_warmup_{name}"), hubert_pt, front, fused)
    out, units = {}, {}
    for name, front, fused in ENCODE_RUNS:
        out_dir = os.path.join(tmp, f"enc_{name}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        summary = run_encode(root, out_dir, hubert_pt, front, fused)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        units[name] = load_units(summary, out_dir)
        for rel, u in units[name].items():
            require(u.dtype == np.float32 and u.shape == (n_frames[rel], 256)
                    and bool(np.isfinite(u).all()),
                    f"encode {name}: {rel} is finite float32 (frames, 256)")
        run = {"run": name, "front": front, "fused_layer": fused, "files": summary["files"],
               "batches": summary["batches"], "audio_seconds": summary["audio_seconds"],
               "wall_seconds": summary["wall_seconds"],
               "audio_s_per_wall_s": summary["audio_seconds"] / summary["wall_seconds"],
               "launches": launches, "expected_launches": expected[name]}
        if name != "faststats":
            cmp = [compare(torch.from_numpy(units[name][rel]),
                           torch.from_numpy(units["faststats"][rel]), 1e-4, 1e-3)
                   for rel in n_frames]
            run["units_vs_faststats"] = {
                "max_abs_err": max(c["max_abs_err"] for c in cmp), "atol": 1e-4, "rtol": 1e-3,
                "within_tol": all(c["within_tol"] for c in cmp)}
        print("encode_run " + json.dumps(run))
        require(summary["files"] == len(ENCODE_SECONDS) and summary["batches"] == n_batches
                and set(units[name]) == set(n_frames), f"encode {name}: every file, 2 batches")
        require(launches == expected[name],
                f"encode {name} launches {launches} != {expected[name]}")
        require(name == "faststats" or run["units_vs_faststats"]["within_tol"],
                f"encode {name}: units match the default front's")
        out[name] = run
    for name, front, fused in ENCODE_RUNS:
        print("encode_profile " + json.dumps({"run": name} | profile_span(
            lambda: run_encode(root, os.path.join(tmp, f"enc_prof_{name}"), hubert_pt, front,
                               fused), encode.LOOP_SPAN)))
    return out


def check_encode_against_cpu(tmp: str, rng: np.random.Generator, hubert_pt: str) -> dict:
    """One 1.3-s file through the encode CLI with the pallas front and the
    fused layer: on the card (K7, K8) against the CPU's plain versions."""
    from quickvc_tpu_torch.data.audio_io import write_wav

    root = os.path.join(tmp, "encode_one")
    os.makedirs(root)
    write_wav(os.path.join(root, "one.wav"), synth_voice(1.3, SR, rng), SR)
    units = {}
    for device in ("cpu", "cuda"):
        out_dir = os.path.join(tmp, f"encode_one_{device}")
        units[device] = load_units(
            run_encode(root, out_dir, hubert_pt, "pallas", True, device=device, batch=1),
            out_dir)["one.npy"]
    out = compare(torch.from_numpy(units["cuda"]), torch.from_numpy(units["cpu"]), 1e-4, 1e-3)
    out["shape"] = list(units["cuda"].shape)
    print("encode_cpu_reference_check " + json.dumps(out))
    require(out["shape"] == [int(1.3 * SR) // 320, 256], "encoded one file's frames")
    require(out["within_tol"], "units encoded on the card match the CPU path")
    return out


# ---------------------------------------------------------------------------
# phase 8: the attention ops API and the int8 probe


def drive_attention_api(dev: torch.device) -> dict:
    """K10 and K9 through their public dispatchers, ``attention`` and
    ``attention_packed_aligned``, in float32 and then on the same inputs in
    bf16 (their bf16 modes), the counters zeroed just before each pass and
    read just after."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.ops import fused_attention as fa

    x = attention_inputs(dev)
    out = {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        z = {k: [t.to(dtype) for t in v] for k, v in x.items()}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with torch.inference_mode():
            outs = {"headed": fa.attention(*z["headed"], 0.125),
                    "headed_d16": fa.attention(*z["headed_d16"], 0.25),
                    "aligned": fa.attention_packed_aligned(*z["aligned"], 12, 0.125)}
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        expected = {name: 0 for name in launches} | {f"attention{suffix}": 2,
                                                     f"attention_packed_aligned{suffix}": 1}
        out |= {f"shapes{suffix}": {k: list(v.shape) for k, v in outs.items()},
                f"dtypes{suffix}": sorted({str(v.dtype) for v in outs.values()}),
                f"launches{suffix}": launches, f"expected_launches{suffix}": expected}
        require(all(bool(torch.isfinite(v).all()) and v.dtype == dtype for v in outs.values()),
                f"attention API outputs are finite {dtype}")
        require(launches == expected, f"attention API launches {launches} != {expected}")
    print("attention_api " + json.dumps(out))
    return out


def run_int8_probe() -> dict:
    """The int8 GEMM probe CLI's entry point on the card, the counters zeroed
    just before and read just after."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.scripts import int8_matmul_probe

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    result = int8_matmul_probe.main(["--device", "cuda", "--iters", "5"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out = {"checks": result["checks"], "launches": launches}
    print("int8_probe " + json.dumps(out))
    require(all(v is not False for v in result["checks"].values()), "int8 probe checks")
    require(launches["mm_s8"] > 0 and launches["mm_bf16"] > 0
            and not any(v for k, v in launches.items() if k not in ("mm_s8", "mm_bf16")),
            f"int8 probe launches {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 9: streaming conversion, the CLI with --streaming against the batch CLI


def check_streaming(tmp: str, rng: np.random.Generator, files) -> dict:
    """16 synthetic sources of 12.1-15.5 s (two full batches) through the
    conversion CLI with and without ``--streaming`` (noise 0), the counters
    zeroed just before each measured run and read just after; outputs
    compared in the interior."""
    from quickvc_tpu_torch import convert, ops
    from quickvc_tpu_torch.data.audio_io import read_wav, write_wav

    hpfile, ptfile, hubert_pt, _ = files
    targets = [os.path.join(tmp, f"tgt{i}.wav") for i in range(len(TARGET_SECONDS))]
    lines, n_frames = [], {}
    for i, sec in enumerate(STREAM_SECONDS):
        path = os.path.join(tmp, f"long{i}.wav")
        wav = synth_voice(sec, SR, rng)
        write_wav(path, wav, SR)
        lines.append(f"long{i}|{path}|{targets[i % len(targets)]}")
        n_frames[f"long{i}"] = len(wav) // 320
    txt = os.path.join(tmp, "stream.txt")
    with open(txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    flags = {"streaming": ["--streaming", "--chunk-frames", str(STREAM_CHUNK),
                           "--context-frames", str(STREAM_CONTEXT)], "batch": []}

    def run(name: str, outdir: str) -> dict:
        return convert.main(["--hpfile", hpfile, "--ptfile", ptfile, "--hubert", hubert_pt,
                             "--txtpath", txt, "--outdir", os.path.join(tmp, outdir),
                             "--device", "cuda", "--batch", str(BATCH), "--noise-scale", "0",
                             *flags[name]])

    for name in flags:   # cuDNN set-up for the window and bucket shapes
        run(name, f"{name}_warmup")
    buckets = Counter(int(np.ceil(sec)) for sec in STREAM_SECONDS)
    n_batches = sum(-(-n // BATCH) for n in buckets.values())
    require(n_batches * BATCH == len(STREAM_SECONDS), "streaming sources fill whole batches")
    windows = sum(-(-n // BATCH) * -(-(sec * SR // 320) // STREAM_CHUNK)
                  for sec, n in buckets.items())
    out = {}
    for name in flags:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        summary = run(name, f"{name}_out")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check_outputs(summary, n_frames)
        expected = {k: 0 for k in launches} | {
            "wave_to_mel": len(TARGET_SECONDS), "attention_packed": 12 * n_batches,
            "polar_inverse_stft": windows if name == "streaming" else n_batches}
        out[name] = {"pairs": summary["pairs"], "batches": n_batches,
                     "row_occupancy": summary["pairs"] / (n_batches * BATCH),
                     "audio_seconds": summary["audio_seconds"],
                     "wall_seconds": summary["wall_seconds"],
                     "audio_s_per_wall_s": summary["audio_seconds"] / summary["wall_seconds"],
                     "launches": launches, "expected_launches": expected}
        require(launches == expected, f"{name} conversion launches {launches} != {expected}")
    edge = EDGE_FRAMES * 320
    diffs = {}
    for title in n_frames:
        a, b = (read_wav(os.path.join(tmp, f"{name}_out", f"{title}.wav"))[0][edge:-edge]
                for name in ("batch", "streaming"))
        diffs[title] = float(np.abs(a - b).max() / np.abs(a).max())
    out["interior_max_abs_over_peak"] = diffs
    out["edge_frames"] = EDGE_FRAMES
    print("streaming_convert " + json.dumps(out))
    print("streaming_profile " + json.dumps(profile_span(
        lambda: run("streaming", "streaming_prof"), convert.LOOP_SPAN)))
    require(max(diffs.values()) <= 1e-3,
            "streaming interiors match the batch path within 1e-3 x peak")
    return out


# ---------------------------------------------------------------------------
# phase 10: live sessions


def profile_ticks(session, window: torch.Tensor, ticks: int = 5) -> dict:
    """``ticks`` steps of a live session under the profiler, in one span."""
    def run():
        with torch.profiler.record_function(LIVE_SPAN):
            for _ in range(ticks):
                session.step(window)
            torch.cuda.synchronize()
    return {"ticks": ticks} | profile_span(run, LIVE_SPAN)


def check_live_sessions(dev: torch.device, net_g, hubert, rng: np.random.Generator) -> dict:
    """The realtime benchmark's points up to 64 streams, each tick's launches
    checked; a profile of unit ticks at N = 1 and wave ticks at N = 64; then a
    full-width unit session against batch ``infer``."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.infer import RealtimeSession, RealtimeWaveSession
    from quickvc_tpu_torch.scripts import realtime_bench

    records = realtime_bench.main(LIVE_ARGS)
    require(len(records) == 10, f"10 live points up to 64 streams, got {len(records)}")
    for rec in records:
        want = {"polar_inverse_stft": 1} | ({"attention_packed": 12}
                                            if rec["domain"] == "wave" else {})
        require(rec["launches_per_tick"] == want,
                f"{rec['domain']} x {rec['streams']} tick launches "
                f"{rec['launches_per_tick']} != {want}")

    net, hubert = net_g.to(dev).eval(), hubert.to(dev).eval()
    for domain, n in (("units", 1), ("wave", 64)):
        g = rng.standard_normal((n, 256)).astype(np.float32)
        kw = dict(chunk=16, left=48, right=16, device=dev)
        if domain == "units":
            session = RealtimeSession(net, g, **kw)
            win = torch.randn(n, 80, 256, device=dev)
        else:
            session = RealtimeWaveSession(net, g, hubert, **kw)
            win = 0.1 * torch.randn(n, 80 * 320, device=dev)
        session.step(win)
        print("live_profile " + json.dumps({"domain": domain, "streams": n}
                                           | profile_ticks(session, win)))

    hop, f, chunk, ctx = 320, PARITY_FRAMES, PARITY_CHUNK, PARITY_CONTEXT
    g = rng.standard_normal((2, 256)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    units = (0.5 * rng.standard_normal((2, f, 256))).astype(np.float32)
    n_push = -(-f // chunk)
    pushed = np.pad(units, ((0, 0), (0, n_push * chunk - f), (0, 0)))
    session = RealtimeSession(net, g, chunk=chunk, left=ctx, right=ctx, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    blocks = [session.push(pushed[:, i * chunk : (i + 1) * chunk]) for i in range(n_push)]
    blocks.append(session.flush())
    launches = ops.launch_counts()
    live = np.concatenate(blocks, axis=1)[:, ctx * hop :]   # drop the lead-in
    with torch.inference_mode():
        batch = net.infer(torch.from_numpy(units).to(dev).transpose(1, 2),
                          torch.from_numpy(g).to(dev), 0.0)[:, 0].cpu().numpy()
    a, b = (x[:, EDGE_FRAMES * hop : (f - EDGE_FRAMES) * hop] for x in (batch, live))
    ticks = n_push + -(-ctx // chunk)
    out = {"streams": 2, "frames": f, "chunk": chunk, "left": ctx, "right": ctx,
           "ticks": ticks, "live_samples": int(live.shape[1]), "edge_frames": EDGE_FRAMES,
           "interior_max_abs_over_peak": float(np.abs(a - b).max() / np.abs(a).max()),
           "launches": launches}
    print("live_parity " + json.dumps(out))
    require(live.shape[1] == n_push * chunk * hop, "live output covers every pushed frame")
    require(launches["polar_inverse_stft"] == ticks and launches["attention_packed"] == 0,
            f"unit session launches {launches}: K3 once a tick")
    require(out["interior_max_abs_over_peak"] <= 1e-3,
            "live session interior matches batch infer within 1e-3 x peak")
    return {"points": records, "parity": out}


def check_sessions_against_cpu(net_g, hubert, rng: np.random.Generator) -> dict:
    """One streaming batch (HuBERT units of two 4-s sources, then
    ``streaming_infer`` with the CLI's chunk and context) and three ticks of a
    wave session at the live benchmark's first window, on the card (K2, K3)
    against the CPU plain path, noise 0."""
    from quickvc_tpu_torch.infer import RealtimeWaveSession, streaming_infer

    hop, chunk = 320, 16
    src = np.stack([synth_voice(4.0, SR, rng) for _ in range(2)])
    live = np.stack([synth_voice(3 * chunk * hop / SR + 1e-3, SR, rng)[: 3 * chunk * hop]
                     for _ in range(2)])
    g = rng.standard_normal((2, 256)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)

    def path(dev):
        h, net = hubert.to(dev), net_g.to(dev)
        with torch.inference_mode():
            units = h.units(torch.from_numpy(src).to(dev)).transpose(1, 2)
            stream = streaming_infer(net, units, torch.from_numpy(g).to(dev), hop,
                                     STREAM_CHUNK, STREAM_CONTEXT, 0.0)
        session = RealtimeWaveSession(net, g, h, chunk=chunk, left=48, right=16, device=dev)
        ticks = [session.push(live[:, i * chunk * hop : (i + 1) * chunk * hop])
                 for i in range(3)]
        return stream.cpu().numpy(), np.concatenate(ticks, axis=1)

    ref = path(torch.device("cpu"))
    ours = path(torch.device("cuda"))
    out = {"streaming_shape": list(ours[0].shape), "wave_ticks_shape": list(ours[1].shape)}
    for name, a, b in (("streaming", ours[0], ref[0]), ("wave_ticks", ours[1], ref[1])):
        out[f"{name}_max_abs_over_peak"] = float(np.abs(a - b).max() / np.abs(b).max())
    print("sessions_cpu_reference_check " + json.dumps(out))
    require(out["streaming_shape"] == [2, 4 * SR] and out["wave_ticks_shape"] == [2, live.shape[1]],
            "streaming and wave-session output lengths")
    require(out["streaming_max_abs_over_peak"] <= 1e-3,
            "streaming on the card matches the CPU path (1e-3 x peak)")
    require(out["wave_ticks_max_abs_over_peak"] <= 1e-3,
            "wave-session ticks on the card match the CPU path (1e-3 x peak)")
    return out


def check_live_bf16(f32_points: list[dict]) -> dict:
    """The live benchmark at ``--precision bf16`` (the JAX benchmark's
    default): the same points as the float32 run, each tick's launches
    checked (K2 in its bf16 mode, 12 a wave tick), the step times printed
    beside the float32 run's of this call."""
    from quickvc_tpu_torch.scripts import realtime_bench

    records = realtime_bench.main(LIVE_ARGS_BF16)
    require(len(records) == len(f32_points), f"{len(f32_points)} bf16 live points")
    for rec in records:
        want = {"polar_inverse_stft": 1} | ({"attention_packed_bf16": 12}
                                            if rec["domain"] == "wave" else {})
        require(rec["launches_per_tick"] == want,
                f"bf16 {rec['domain']} x {rec['streams']} tick launches "
                f"{rec['launches_per_tick']} != {want}")
    side = [{"domain": a["domain"], "streams": a["streams"], "chunk_ms": a["chunk_ms"],
             "f32_step_ms": a["step_ms"], "bf16_step_ms": b["step_ms"]}
            for a, b in zip(f32_points, records)]
    print("live_bf16 " + json.dumps({"vs_f32": side}))
    return {"points": records, "vs_f32": side}


def check_bf16_session_against_cpu(net_g, hubert, rng: np.random.Generator,
                                   name: str = "bf16_session", per_tick=None) -> dict:
    """Three ticks of a 2-stream bf16 wave session (chunk 16, left 48, right
    16, noise 0) on the card (by default K2 bf16 and K3; ``per_tick`` gives
    another HuBERT's launches a tick) against the same session on the CPU,
    the CPU's float32 session the yardstick (PERF.md section 2):
    ``max|card - cpu| <= max(2 max|cpu - cpu_f32|, 1e-2 peak)``. The card's
    launches are this path's: the counters zeroed just before it."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.infer import RealtimeWaveSession

    hop, chunk, ticks = 320, 16, 3
    live = np.stack([synth_voice(ticks * chunk * hop / SR + 1e-3, SR, rng)[: ticks * chunk * hop]
                     for _ in range(2)])
    g = rng.standard_normal((2, 256)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)

    def path(dev, dtype):
        h, net = hubert.to(dev), net_g.to(dev)
        session = RealtimeWaveSession(net, g, h, chunk=chunk, left=48, right=16, device=dev,
                                      dtype=dtype)
        return np.concatenate([session.push(live[:, i * chunk * hop : (i + 1) * chunk * hop])
                               for i in range(ticks)], axis=1)

    cpu = torch.device("cpu")
    ref32, ref = path(cpu, torch.float32), path(cpu, torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ours = path(torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    per_tick = per_tick or {"attention_packed_bf16": 12, "polar_inverse_stft": 1}
    expected = {k: 0 for k in launches} | {k: n * ticks for k, n in per_tick.items()}
    err, bf16_err = float(np.abs(ours - ref).max()), float(np.abs(ref - ref32).max())
    peak = float(np.abs(ref32).max())
    out = {"streams": 2, "ticks": ticks, "shape": list(ours.shape), "max_abs_err": err,
           "cpu_bf16_vs_f32_max_abs": bf16_err, "peak": peak,
           "bound": max(2 * bf16_err, 1e-2 * peak), "launches": launches,
           "expected_launches": expected}
    print(f"{name}_cpu_reference_check " + json.dumps(out))
    require(ours.shape == (2, ticks * chunk * hop), f"{name} output length")
    require(launches == expected, f"{name} launches {launches} != {expected}")
    require(err <= out["bound"], f"the {name} on the card matches the CPU's")
    return out


def pallas_hubert(hubert):
    """The same HuBERT-soft with the `pallas` front (K7) and every layer fused (K8)."""
    from quickvc_tpu_torch.models.hubert import HubertSoft

    h = HubertSoft(front="pallas", use_fused_layer=True)
    h.load_state_dict(hubert.state_dict())
    return h.eval()


def time_pallas_bf16_session(net_g, hubert, hub_pallas, rng: np.random.Generator) -> dict:
    """The bf16 wave session at N = 64 (chunk 16, left 48, right 16), its step
    time in CUDA events over 5 ticks, with the `pallas` front and fused
    layers and with the default `faststats` HuBERT, in turns (faststats,
    pallas, pallas, faststats). A number, not a claim."""
    from quickvc_tpu_torch.infer import RealtimeWaveSession

    dev, n, chunk, left, right = torch.device("cuda"), LIVE_STREAMS, 16, 48, 16
    g = rng.standard_normal((n, 256)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    win = torch.from_numpy((0.1 * rng.standard_normal((n, (left + chunk + right) * 320)))
                           .astype(np.float32)).to(dev)
    sessions = {k: RealtimeWaveSession(net_g.to(dev), g, h.to(dev), chunk=chunk, left=left,
                                       right=right, device=dev, dtype=torch.bfloat16)
                for k, h in (("faststats", hubert), ("pallas_fused_layer", hub_pallas))}
    for s in sessions.values():
        s.step(win)   # cuDNN set-up for this shape
    order = ["faststats", "pallas_fused_layer", "pallas_fused_layer", "faststats"]
    readings = [(k, cuda_ms(lambda k=k: sessions[k].step(win), iters=5, warmup=1))
                for k in order]
    out = {"streams": n, "chunk": chunk, "left": left, "right": right, "ticks": 5,
           "turns": readings} | {f"{k}_step_ms": sum(ms for kk, ms in readings if kk == k) / 2
                                 for k in sessions}
    print("live_pallas_bf16 " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.convert import LOOP_SPAN
    from quickvc_tpu_torch.ops import _cuda, fused_mel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    t0 = time.time()
    lib = _cuda.build()
    _cuda.library()
    build_log = (lib.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in build_log.splitlines() if "registers" in ln or "spill" in ln]
    watched = ptxas_report(build_log)
    print("build " + json.dumps({"seconds": round(time.time() - t0, 2), "library": lib.name,
                                 "ptxas": ptxas}))
    # the compiler version beside the ptxas report: K11's accumulator fences
    # (csrc/int8_mm.cu) answer what one version of it did
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True)
    print("ptxas " + json.dumps({
        "nvcc": nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout.strip() else None,
        "warnings": [ln.strip() for ln in build_log.splitlines() if "warning" in ln.lower()],
        "kernels": watched}))
    require({r["kernel"] for r in watched.values()} == set(PTXAS_WATCH),
            f"ptxas report names {PTXAS_WATCH}")
    spilled = [e for e, r in watched.items()
               if r.get("spill_store_bytes", 0) or r.get("spill_load_bytes", 0)]
    require(not spilled, f"watched kernel bodies spill: {spilled}")
    # the bf16 attention's plan at each of its path shapes, for both bodies,
    # with each body's CTAs an SM, registers and shared memory on this card
    from quickvc_tpu_torch.scripts.kernel_times import attention_bf16_plans

    print("attention_bf16_plans " + json.dumps(attention_bf16_plans(dev)))

    kernels = check_kernels(dev, rng)
    bad = [k["name"] for k in kernels if not k["within_tol"]]
    attention_api = drive_attention_api(dev)
    probe = run_int8_probe()

    with tempfile.TemporaryDirectory(prefix="qvc_smoke_") as tmp:
        cfg, net_g, hubert, files, n_frames = make_inputs(
            tmp, rng, os.path.join(ROOT, "configs", "quickvc.json"))
        run_convert(files, os.path.join(tmp, "warmup"))  # cuDNN set-up, allocator
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        summary = run_convert(files, os.path.join(tmp, "out"))
        launches = ops.launch_counts()
        mel_routes = dict(fused_mel.STATS.routes)
        runs = [summary] + [run_convert(files, os.path.join(tmp, f"out{i}"))
                            for i in range(1, REPEATS)]
        for run in runs:
            check_outputs(run, n_frames)
        print("profile " + json.dumps(profile_span(
            lambda: run_convert(files, os.path.join(tmp, "prof")), LOOP_SPAN)))
        train = check_training(tmp, rng, files, n_frames)
        encoding = check_encoding(tmp, rng, files[2])
        check_encode_against_cpu(tmp, rng, files[2])
        train16 = check_training_bf16(tmp, train)
        check_streaming(tmp, rng, files)
        live = check_live_sessions(dev, net_g, hubert, rng)
        check_live_bf16(live["points"])
    buckets = Counter(int(np.ceil(s)) for s in SOURCE_SECONDS)   # 1-s length buckets
    n_batches = sum(-(-n // BATCH) for n in buckets.values())
    expected = {name: 0 for name in launches} | {
        "wave_to_mel": len(TARGET_SECONDS), "attention_packed": 12 * n_batches,
        "polar_inverse_stft": n_batches}
    audio = sum(r["audio_seconds"] for r in runs)
    wall = sum(r["wall_seconds"] for r in runs)
    throughput = {"pairs": summary["pairs"], "batches": n_batches, "repeats": REPEATS,
                  "audio_seconds": audio, "wall_seconds": wall,
                  "audio_s_per_wall_s": audio / wall,
                  "per_run_audio_s_per_wall_s": [r["audio_seconds"] / r["wall_seconds"]
                                                 for r in runs],
                  "launches": launches, "expected_launches": expected,
                  "wave_to_mel_routes": mel_routes}
    print("convert " + json.dumps(throughput))
    reference = check_against_cpu(cfg, net_g, hubert, rng)
    check_sessions_against_cpu(net_g, hubert, rng)
    bf16_session = check_bf16_session_against_cpu(net_g, hubert, rng)
    # the pallas-front session on its own seeds, torch's generators restored
    # after it: the phases after it draw what they drew before it was added
    with torch.random.fork_rng(devices=[dev]):
        rng_pallas = np.random.default_rng(SEED + 14)
        hub_pallas = pallas_hubert(hubert)
        pallas_session = check_bf16_session_against_cpu(
            net_g, hub_pallas, rng_pallas, "pallas_bf16_session", PALLAS_BF16_TICK)
        time_pallas_bf16_session(net_g, hubert, hub_pallas, rng_pallas)
    disc = check_disc_fused(dev, rng)
    disc16 = check_disc_fused_bf16(dev)
    run_disc_ab()
    check_train_step_against_cpu(rng)
    _, lstm_rows = check_speaker_lstm_bf16()
    check_lstm_stack_residency()
    run_bf16_step_gate()
    for r in lstm_rows:
        r["bound_ms"] = max(r["bound_ops_ms"], r["bound_bytes_ms"])
        r["bound_by"] = "operations" if r["bound_ops_ms"] >= r["bound_bytes_ms"] else "bytes"
    kernels += lstm_rows
    bad = [k["name"] for k in kernels if not k["within_tol"]]

    # launches: each kernel's count in the path that runs it (the counters
    # zeroed just before that path, read just after)
    path_of = {"wave_to_mel": ("convert", launches), "attention_packed": ("convert", launches),
               "attention_packed_bf16": ("live_bf16_session", bf16_session["launches"]),
               "polar_inverse_stft": ("convert", launches),
               "wave_to_spec_halo": ("train", train["launches"]),
               "conv5_lrelu": ("disc_fused_path", disc["launches"]),
               "conv5_lrelu_dw": ("disc_fused_path", disc["launches"]),
               "conv5_lrelu_bf16": ("disc_fused_bf16_path", disc16["launches"]),
               "conv5_lrelu_dw_bf16": ("disc_fused_bf16_path", disc16["launches"]),
               "extractor_front": ("encode_pallas", encoding["pallas"]["launches"]),
               "transformer_layer": ("encode_pallas_fused_layer",
                                     encoding["pallas_fused_layer"]["launches"]),
               "attention": ("attention_api", attention_api["launches"]),
               "attention_packed_aligned": ("attention_api", attention_api["launches"]),
               "extractor_front_bf16": ("live_pallas_bf16_session", pallas_session["launches"]),
               "transformer_layer_bf16": ("live_pallas_bf16_session",
                                          pallas_session["launches"]),
               "attention_bf16": ("attention_api_bf16", attention_api["launches_bf16"]),
               "attention_packed_aligned_bf16": ("attention_api_bf16",
                                                 attention_api["launches_bf16"]),
               "mm_s8": ("int8_probe", probe["launches"]),
               "mm_bf16": ("int8_probe", probe["launches"]),
               "lstm_stack_bf16": ("train_bf16", train16["launches"]),
               "lstm_stack_bf16_backward": ("train_bf16", train16["launches"])}
    for k in kernels:
        k["path"], counts = path_of[k["name"]]
        k["launches"] = counts[k["name"]]
        detail = {x: k[x] for x in ("name", "tpu_id", "shape", "max_abs_err", "max_rel_err",
                                    "atol", "rtol", "within_tol", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by", "path", "launches")}
        for extra in ("mel_route", "checks", "autograd_function_ok", "deterministic",
                      "dx_ms", "dx_device_ms", "dx_plain_ms", "dx_library_ms",
                      "dx_library_device_ms", "timings", "dw_plan", "affine_ms",
                      "library_max_abs_err", "launches_per_call", "plans", "ms_split_k",
                      "padded_lanes_zero", "tile", "ms_turns",
                      "library_ms_turns", "device_ms", "library_device_ms",
                      "transpose_ms", "library_b_col_major_ms",
                      "bound_f32_fma_ms", "ms_2048", "ms_800_dense", "ms_4096_dense",
                      "device_kernels", "pre_pass_launched", "library_f32_out_ms",
                      "library_f32_out_note", "ms_32_8", "dense_800_ms",
                      "dense_800_plain_ms", "dense_800_bound_ms", "device_ms_shapes",
                      "l2_cold_device_ms", "err_f64_kernel", "err_f64_plain", "dtype",
                      "err_f32_kernel", "err_f32_plain", "serial_steps", "library_note",
                      "library_events_ms", "plan", "plans", "backward_alone_ms",
                      "backward_alone_device_ms", "backward_alone_library_ms", "layers",
                      "three_layer_chain_ms", "equal_to_layer_chain", "bodies", "body",
                      "three_layer_chain_device_ms", "chain_turns_ms",
                      "chain_turns_device_ms", "projections_within_ulp",
                      "layers_equal_one_layer_kernel", "accuracy"):
            if extra in k:
                detail[extra] = k[extra]
        print("kernel_check " + json.dumps(detail))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"tpu_kernels": [{"id": i, "pallas_call": at, "function": fn,
                                       "status": st} for i, at, fn, st in TPU_KERNELS]}))
    require(not bad, f"kernels outside tolerance: {bad}")
    require(launches == expected, f"launch counts {launches} != expected {expected}")
    require(mel_routes == {"fft": len(TARGET_SECONDS)},
            f"the conversion's log-mels took routes {mel_routes}, not the FFT")
    require(not any(k.get("pre_pass_launched") for k in kernels),
            "a bf16 K11 call launched the B^T pre-pass")
    require(reference["wave_shape"][-1] == SR, "CPU-reference wave length")
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"]}
        | ({"status": REDESIGNED[k["name"]]} if k["name"] in REDESIGNED else {})
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
