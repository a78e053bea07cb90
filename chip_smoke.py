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
15. The other two decoders of ``configs/quickvc.json``'s widths and the
    input formats (on seeds of their own): the conversion CLI with a seeded
    multiband generator (``mb_istft_vits``), batch and ``--streaming``,
    K3's launches and (rows, frames) recorded and K3 held against its plain
    version on the inputs the decoder handed it, one batch of ``infer``
    against the CPU (1e-3 x peak); the trainer with the multiband decoder
    at bf16 for 4 full-width steps, ``loss/g/subband`` non-zero at every
    step in its event files and finite but where the guard skipped the
    update (+inf on a crop of digital silence, as in JAX), its step walls
    beside the multistream run's; the single-band decoder (``istft_vits``) at full width on one
    conversion batch, K3 once on 8 rows, against the CPU; FLAC input:
    ``python -m quickvc_tpu_torch.downsample`` over 48 kHz FLACs (written
    here, 16-bit verbatim subframes) and over the same samples as s16 WAVs,
    the 16 kHz outputs bit-equal, then 2 training steps from 16 kHz FLAC
    entries whose bucket lengths are the exact probe's; the small training
    step against the CPU with the multiband decoder, in float32 (in two
    parts: the step with the sub-band term's gradient cut, and that term's
    gradient on the same bands) and at bf16; and the ``.msgpack`` reader decoding flax's layout with neither
    ``msgpack`` nor ``flax`` installed.
16. Data-parallel training across processes, on phase 4's corpus and
    config: (a) the trainer CLI under ``torchrun --nproc-per-node 1 ...
    --distributed`` (NCCL) for 3 full-width steps at batch 32, its
    ``G_3.pth`` and ``D_3.pth`` bit-equal to the plain trainer's 3 steps,
    both run on cuDNN's deterministic algorithms, the step walls of both;
    (b) two gloo ranks sharing the card (spawned processes),
    16 rows each of one batch of 32: 2 float32 steps and one each of the
    bf16 reduce, ZeRO-1 and ``split_prior``, the ranks' parameters
    bit-equal after every step, K4 once a step on each rank, the reduced
    gradients against one process on the 32 rows with the same draws (and
    one rank's own unreduced gradients failing the same gate), the bf16
    mean bit-equal to ``round_bf16(a + b) / 2``; (c) NCCL
    across the cards where there are two or more (the collectives' bytes
    and CUDA-event times from ``quickvc_tpu_torch.scripts.dp_collectives``,
    the trainer's step walls), else one line saying why it did not run.
17. On phase 4's corpus: (a) a full-width step at float32 and at bf16 timed
    in turns, twice each, with cuDNN free and on deterministic algorithms
    (the trainer's ``--deterministic``), K4 and the LSTM stacks bit-equal from launch to
    launch on them, then the trainer CLI with ``--deterministic`` for 4
    straight steps against 2 steps and a resume in a new process to 4, at
    each precision, ``G_4.pth`` and ``D_4.pth`` byte-equal; (b) the
    multiband model on two gloo ranks sharing the card at a float32 reduce
    against one process on the batch of 32 by (16 b)'s gate (the sub-band
    loss's spectral convergence one ratio over both ranks' rows), the gate
    refusing rank 0's unreduced gradients; (c) tensor parallelism at
    ``configs/quickvc_tp.json`` (upsample 4096; batch 64 cut to 8): a 1 x 2
    (data, model) mesh of two gloo ranks on card 0, with two cards also NCCL
    at 1 x 2 and with four 2 x 2, each against the replicated one-process
    steps on deterministic cuDNN (float32: losses rtol 2e-4, gradients by
    (16 b)'s gate on TP_DRAWS draws, which must refuse the replicated
    gradients of half the rows; bf16 by PERF.md section 2's rules) and its sharded ``infer``
    against the whole one (1e-3 x peak); K4 once a step on every rank, the
    LSTM stacks once a bf16 step, K3 once in every rank's ``infer``; bytes
    a rank against replicated, peak memory, step walls and the model-axis
    collectives.
18. The profiling harness and the exporter: (a) the trainer CLI at bf16 on
    phase 4's corpus with ``--max-steps 7 --profile-steps 2``: one Chrome
    trace in ``model_dir/profile`` holding two ``quickvc_train_step`` spans
    and two K4 kernel records, its LSTM stack records printed beside the two
    of each the launch counters see (CUPTI has dropped such records), the
    traced steps' walls beside the untraced ones; phase 4's runs (no
    ``--profile-steps``) wrote no ``profile/``; (b) ``utils.profiling.timed``
    and ``time_chained`` on K4 at phase 4's batch beside phase 1's event
    time, ``time_chained`` launching K4 once a run; (c)
    ``python -m quickvc_tpu_torch.scripts.export_params`` on phase 4's newest
    checkpoint pair (``.msgpack`` and ``--format torch --disc-out``) and on
    phase 2's ``hubert-soft.pt``, with no ``msgpack`` or ``flax`` imported:
    the files read back bit-equal to the checkpoints, and the conversion
    CLI from ``g.msgpack`` and ``hubert.msgpack`` launching K1, K2 and K3 as
    the ``.pth`` route does and within 1e-3 x peak of its waves.

Prints one JSON line per check, the card's name and power limit, the status
of every TPU kernel of the JAX package, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
Without a CUDA card, or outside a checkout of the repo, it exits non-zero
and prints no result. Imports nothing of JAX or ``quickvc_tpu``.
"""

from __future__ import annotations

import contextlib
import functools
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
     "redesigned: persistent planned grid, host-built tables, loads one step ahead; the head "
     "of all three decoders (multistream, multiband, single-band)"),
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
# phase 15: the other two decoders of configs/quickvc.json's widths, FLAC input
MB_MODEL = {"ms_istft_vits": False, "mb_istft_vits": True}
ISTFT_MODEL = {"ms_istft_vits": False, "istft_vits": True}
DOWNSAMPLE_INPUTS = [(1.7, 1), (2.3, 2), (1.1, 1)]   # 48 kHz FLAC/WAV: (seconds, channels)
FLAC_SECONDS = [4.1 + 0.1 * i for i in range(8)]     # 16 kHz FLAC training entries, one batch
FLAC_TRAIN_STEPS = 2
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


PHASE_SECONDS: dict[str, float] = {}   # phase -> seconds of wall, printed as phase_seconds
_LAST_MARK = [time.perf_counter()]


def mark(phase: str) -> None:
    """Add the seconds since the last mark to ``phase``'s wall."""
    now = time.perf_counter()
    PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + now - _LAST_MARK[0]
    _LAST_MARK[0] = now


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


def run_convert(files, outdir: str, device: str = "cuda", extra=()) -> dict:
    from quickvc_tpu_torch import convert

    hpfile, ptfile, hubert_pt, txt = files
    return convert.main(["--hpfile", hpfile, "--ptfile", ptfile, "--hubert", hubert_pt,
                         "--txtpath", txt, "--outdir", outdir, "--device", device,
                         "--batch", str(BATCH), *extra])


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
    steps]}} (kind: scalar, image, audio, histogram), and "values": {tag:
    {step: value}} of the scalars."""
    import struct

    files = sorted(n for n in os.listdir(log_dir) if n.startswith("events.out.tfevents."))
    require(bool(files), f"event files in {log_dir}")
    kinds = {2: "scalar", 4: "image", 5: "histogram", 6: "audio"}
    out = {"files": len(files), "records": 0, "file_version": [], "tags": {}, "values": {}}
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
                        if kind == "scalar" and len(parts.get(2, b"")) == 4:   # simple_value
                            out["values"].setdefault(tag, {})[step] = struct.unpack(
                                "<f", parts[2])[0]
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


def check_train_step_against_cpu(rng: np.random.Generator, model: dict | None = None,
                                 label: str = "train_cpu_reference_check",
                                 offset: int = 0, short: int = 5) -> dict:
    """A small config (its model updated by ``model``: the multiband decoder
    adds the sub-band loss; ``offset`` samples of each synthetic wave are
    skipped, and the second item is ``short`` frames short of the crop), the
    same weights, compact batch and draws on
    both, in float32 (losses rtol 2e-4, gradients 2e-3) and at ``precision:
    "bf16"``, held relative to the bf16 error of the CPU step against its
    float32 step (PERF.md section 2): losses ``|card - cpu| <= max(2 |cpu -
    cpu_f32|, 4e-3 |cpu_f32|)``, each gradient ``maxrel(card, cpu) <= max(2
    maxrel(cpu, cpu_f32), 2e-2)``; every parameter float32 afterwards. The
    posterior noise is bf16-valued, so both precisions draw the same.

    With the sub-band loss, float32 does not determine the step's G
    gradients to 2e-3: the generated bands' STFT has bins near the float32
    rounding of the decoder's output, where the log-magnitude's 1/|z| turns
    the rounding into most of the gradient. So the float32 gradients are
    held in two parts, each at 2e-3: the step with the sub-band term's value
    kept and its gradient cut (its losses, D and G gradients), and the
    term's gradient with respect to the generated bands, card against CPU
    on the CPU step's own bands. Printed beside them, not held: the whole
    step's G gradient difference, the CPU step on oneDNN against it on the
    native convolutions, the smallest bins over each row's maximum, and the
    term's gradient with float32 magnitudes (the JAX package's arithmetic)
    against the float64 ones, on each device."""
    import copy

    from quickvc_tpu_torch.config import config_from_dict
    from quickvc_tpu_torch.dsp.stft import magnitude_stft
    from quickvc_tpu_torch.losses import subband_stft_loss
    from quickvc_tpu_torch.train import step as step_module
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    def small(precision: str):
        return config_from_dict({
            "train": {"segment_size": 2560, "max_speclen": 32, "precision": precision,
                      "learning_rate": 1e-4, "disc_width": 0.25, "batch_size": 2},
            "model": {"inter_channels": 16, "hidden_channels": 16,
                      "upsample_initial_channel": 32, "gin_channels": 16,
                      "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
                      "enc_wn_layers": 2, "flow_wn_layers": 2, "n_flows": 2} | (model or {})})

    frames = 16
    wave = np.stack([synth_voice(1.0, SR, rng)[offset : offset + frames * 320 + 960]
                     for _ in range(2)])
    batch = {"unit": torch.from_numpy(rng.standard_normal((2, frames, 256)).astype(np.float32)),
             "wave_s16": torch.from_numpy(np.round(wave * 32767).astype(np.int16)),
             "n_take": torch.tensor([frames, frames - short], dtype=torch.int32)}
    eps_q = torch.from_numpy(rng.standard_normal((2, 16, frames)).astype(np.float32))
    eps_q = eps_q.bfloat16().float()
    ids = torch.tensor([3, 8])
    base = create_train_state(small("f32"), torch.device("cpu"))
    subband = bool((model or {}).get("mb_istft_vits"))
    results, params_f32, bands = {}, True, []

    def cut(y_mb, y_hat_mb, *resolutions):   # the term's value, no gradient; keeps its inputs
        if y_mb.device.type == "cpu":
            bands[:] = [y_mb.detach(), y_hat_mb.detach()]
        return subband_stft_loss(y_mb, y_hat_mb, *resolutions).detach()

    both = ("cpu", "cuda")
    # with the sub-band loss also: its gradient cut, and the CPU step on oneDNN
    runs = [("f32", "", both), ("bf16", "", both)] + (
        [("f32", "cut", both), ("f32", "onednn", ("cpu",))] if subband else [])
    for precision, mode, devices in runs:
        cfg = small(precision)
        for name in devices:
            dev = torch.device(name)
            state = create_train_state(cfg, dev, copy.deepcopy(base.net_g),
                                       copy.deepcopy(base.net_d))
            step_module.subband_stft_loss = cut if mode == "cut" else subband_stft_loss
            # the CPU side on torch's native convolutions: oneDNN's float32 weight
            # gradients of the scale discriminator's first convolutions drift by
            # up to 3e-3 of their max, depending on the thread count
            try:
                with torch.backends.mkldnn.flags(enabled=mode == "onednn"):
                    results[precision + mode, name] = train_step(
                        state, {k: v.to(dev) for k, v in batch.items()}, mel_basis(cfg, dev),
                        eps_q=eps_q.to(dev), ids_slice=ids, debug_grads=True)
            finally:
                step_module.subband_stft_loss = subband_stft_loss
            params_f32 &= all(p.dtype == torch.float32 for net in (state.net_g, state.net_d)
                              for p in net.parameters())
    loss_keys = ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl",
                 "loss/g/total") + (("loss/g/subband",) if subband else ())

    def maxrel(a, b) -> float:
        return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max().clamp(min=1e-6))

    ref, ours = results["f32", "cpu"], results["f32", "cuda"]
    if subband:
        require(0 < float(ref["loss/g/subband"]) < float("inf"),
                f"{label}: a finite, non-zero sub-band loss")
        require("dec.subband_conv_post.weight_v" in ref["debug/g_grads"],
                f"{label}: the gradients cover dec.subband_conv_post")
    def grad_errors(ours, ref) -> dict:
        return {which: max(maxrel(ours[f"debug/{which}_grads"][k], v)
                           for k, v in ref[f"debug/{which}_grads"].items())
                for which in ("d", "g")}

    losses = {k: [float(ours[k]), float(ref[k])] for k in loss_keys}
    grad_err = grad_errors(ours, ref)
    term_ok, term = True, {}
    if subband:   # float32 in two parts (see above); the whole step's G error printed
        term["whole_step_grad_max_rel_err"] = grad_err
        grad_err = grad_errors(results["f32cut", "cuda"], results["f32cut", "cpu"])
        t = small("f32").train
        resolutions = (t.fft_sizes, t.hop_sizes, t.win_lengths)

        def term_grad(dev):
            y_mb, y_hat = (x.to(dev) for x in bands)
            y_hat = y_hat.clone().requires_grad_(True)
            subband_stft_loss(y_mb, y_hat, *resolutions).backward()
            return y_hat.grad.cpu().double()

        term["grad_max_rel_err"] = maxrel(term_grad("cuda"), term_grad("cpu"))
        term_ok = term["grad_max_rel_err"] < 2e-3
        # printed, not held: why float32 cannot hold the whole step's G gradient
        term["cpu_onednn_vs_native_g"] = grad_errors(results["f32onednn", "cpu"], ref)["g"]
        y_mb, y_hat = bands
        t_len = y_mb.shape[-1]
        gen = y_hat.reshape(-1, y_hat.shape[-1])[:, :t_len]
        term["band_bins_min_over_max"] = {}
        for n_fft, hop, win in zip(*resolutions):
            mag = magnitude_stft(gen, n_fft, hop, win)
            term["band_bins_min_over_max"][n_fft] = float(
                (mag / mag.amax(dim=(-2, -1), keepdim=True)).min())

        def term_grad_f32(dev):   # the JAX package's arithmetic: magnitudes in float32
            x = gen.to(dev).clone().requires_grad_(True)
            y = y_mb.reshape(-1, t_len).to(dev)
            loss = 0.0
            for n_fft, hop, win in zip(*resolutions):
                xm, ym = (magnitude_stft(z, n_fft, hop, win) for z in (x, y))
                loss = (loss + torch.linalg.vector_norm(ym - xm) / torch.linalg.vector_norm(ym)
                        + torch.mean(torch.abs(torch.log(ym) - torch.log(xm))))
            (loss / len(resolutions)).backward()
            return x.grad.cpu().double().reshape(y_hat[..., :t_len].shape)

        g64 = term_grad("cpu")[..., :t_len]
        term["f32_magnitudes_err_vs_f64"] = {dev: maxrel(term_grad_f32(dev), g64)
                                             for dev in both}
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
    if subband:
        out["subband_term"] = term
    print(f"{label} " + json.dumps(out))
    require(term_ok, f"{label}: the sub-band term's gradient on the card matches the CPU's")
    require(all(abs(a - b) <= 1e-5 + 2e-4 * abs(b) for a, b in losses.values()),
            f"{label}: training losses on the card match the CPU path")
    require(max(grad_err.values()) < 2e-3,
            f"{label}: training gradients on the card match the CPU path")
    require(loss16_ok, f"{label}: bf16 training losses on the card match the CPU path")
    require(grad16_ok, f"{label}: bf16 training gradients on the card match the CPU path")
    require(params_f32, f"{label}: every parameter stays float32 after a bf16 step")
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


# ---------------------------------------------------------------------------
# phase 15: the multiband and single-band decoders, FLAC corpora, .msgpack files


def write_config(path: str, base: str, model=None, train=None, data=None) -> str:
    """``base`` (a config file) with its sections updated, written to ``path``."""
    with open(base) as f:
        cfg = json.load(f)
    for section, update in (("model", model), ("train", train), ("data", data)):
        cfg[section].update(update or {})
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


class K3Spy:
    """Inside: every K3 dispatch the decoders make is recorded as (rows,
    frames, bins), and the first call's inputs are kept (cloned), so K3 can be
    held against its plain version on what the path handed it."""

    def __enter__(self):
        from quickvc_tpu_torch.models import decoders

        self.calls, self.first, self._real = [], None, decoders.polar_inverse_stft

        def spy(log_mag, phase, n_fft, hop):
            self.calls.append([*log_mag.shape, n_fft, hop])
            if self.first is None:
                self.first = (log_mag.clone(), phase.clone(), n_fft, hop)
            return self._real(log_mag, phase, n_fft, hop)

        decoders.polar_inverse_stft = spy
        return self

    def __exit__(self, *exc):
        from quickvc_tpu_torch.models import decoders

        decoders.polar_inverse_stft = self._real

    def check(self) -> dict:
        """K3 on the first call's inputs against its plain version (atol 1e-4, rtol 1e-3)."""
        from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as istft_plain
        from quickvc_tpu_torch.ops import fused_istft

        lm, ph, n_fft, hop = self.first
        return compare(fused_istft.polar_inverse_stft_kernel(lm, ph, n_fft, hop),
                       istft_plain(lm, ph, n_fft, hop), 1e-4, 1e-3) | {"shape": list(lm.shape)}


def seeded_generator(cfg, seed: int):
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import init_random_

    return init_random_(SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model), seed)


def check_decoder_against_cpu(net, rng: np.random.Generator, name: str) -> dict:
    """``infer`` of one conversion batch (8 x 100 unit frames, noise 0) on the
    card, K3 in the head, against the CPU plain path: max-abs <= 1e-3 x peak."""
    from quickvc_tpu_torch import ops

    units = torch.from_numpy((0.5 * rng.standard_normal((BATCH, 256, 100))).astype(np.float32))
    g = rng.standard_normal((BATCH, 256)).astype(np.float32)
    g = torch.from_numpy(g / np.linalg.norm(g, axis=1, keepdims=True))

    def path(dev):
        with torch.inference_mode():
            return net.to(dev).infer(units.to(dev), g.to(dev), noise_scale=0.0).cpu()

    ref = path(torch.device("cpu"))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with K3Spy() as spy:
        ours = path(torch.device("cuda"))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    err = float((ours - ref).abs().max() / ref.abs().max())
    out = {"decoder": net.model_cfg.decoder_kind, "shape": list(ours.shape),
           "samples_per_frame": net.dec.samples_per_frame, "k3_calls": spy.calls,
           "k3_launches": launches["polar_inverse_stft"], "k3_check": spy.check(),
           "wave_max_abs_over_peak": err, "finite": bool(torch.isfinite(ours).all())}
    print(f"{name} " + json.dumps(out))
    expected = {k: 0 for k in launches} | {"polar_inverse_stft": 1}
    require(launches == expected, f"{name}: launches {launches} != {expected}")
    require(out["finite"] and err <= 1e-3, f"{name}: the card matches the CPU (1e-3 x peak)")
    require(out["k3_check"]["within_tol"], f"{name}: K3 matches its plain version")
    return out


def check_mb_conversion(tmp: str, files, n_frames) -> dict:
    """The conversion CLI with a seeded multiband generator at full width
    (``configs/quickvc.json`` with ``mb_istft_vits``), the HuBERT and pairs of
    phase 3, batch and ``--streaming`` (noise 0), the counters zeroed just
    before each run and read just after: K3 once a batch (once a window
    streaming), on 4 x 8 rows each, held against its plain version on the
    inputs the decoder handed it; then one batch against the CPU."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config

    _, _, hubert_pt, txt = files
    hpfile = write_config(os.path.join(tmp, "mb_config.json"),
                          os.path.join(ROOT, "configs", "quickvc.json"), model=MB_MODEL)
    cfg = load_config(hpfile)
    require(cfg.model.decoder_kind == "mb_istft", "the multiband config")
    net = seeded_generator(cfg, SEED + 19)
    ptfile = os.path.join(tmp, "G_mb.pth")
    torch.save({"model": net.state_dict(), "iteration": 0}, ptfile)
    mb_files = [hpfile, ptfile, hubert_pt, txt]
    stream_flags = ["--streaming", "--chunk-frames", str(STREAM_CHUNK),
                    "--context-frames", str(STREAM_CONTEXT), "--noise-scale", "0"]
    buckets = Counter(int(np.ceil(s)) for s in SOURCE_SECONDS)
    n_batches = sum(-(-n // BATCH) for n in buckets.values())
    windows = sum(-(-n // BATCH) * -(-(sec * SR // 320) // STREAM_CHUNK)
                  for sec, n in buckets.items())
    out = {}
    for name, extra in (("batch", ["--noise-scale", "0"]), ("streaming", stream_flags)):
        run_convert(mb_files, os.path.join(tmp, f"mb_{name}_warmup"), extra=extra)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with K3Spy() as spy:
            summary = run_convert(mb_files, os.path.join(tmp, f"mb_{name}"), extra=extra)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check_outputs(summary, n_frames)
        k3 = windows if name == "streaming" else n_batches
        expected = {k: 0 for k in launches} | {
            "wave_to_mel": len(TARGET_SECONDS), "attention_packed": 12 * n_batches,
            "polar_inverse_stft": k3}
        frames = ([20 * (STREAM_CHUNK + 2 * STREAM_CONTEXT) + 1] if name == "streaming"
                  else [20 * sec * SR // 320 + 1 for sec in sorted(buckets)])
        out[name] = {"pairs": summary["pairs"], "audio_s_per_wall_s":
                     summary["audio_seconds"] / summary["wall_seconds"],
                     "launches": launches, "expected_launches": expected,
                     "k3_calls": spy.calls, "k3_check": spy.check()}
        require(launches == expected, f"MB {name} conversion launches {launches} != {expected}")
        require(all(c[0] == 4 * BATCH and c[1] in frames and c[2:] == [9, 16, 4]
                    for c in spy.calls) and len(spy.calls) == k3,
                f"MB {name}: K3 on {4 * BATCH} rows of {frames} frames, {k3} times")
        require(out[name]["k3_check"]["within_tol"], f"MB {name}: K3 matches its plain version")
    print("mb_convert " + json.dumps(out))
    out["cpu"] = check_decoder_against_cpu(net, np.random.default_rng(SEED + 19),
                                           "mb_cpu_reference_check")
    out["hpfile"] = hpfile
    return out


def check_single_band_decoder() -> dict:
    """The single-band decoder (``istft_vits``) at the full width of
    ``configs/quickvc.json``, seeded: ``infer`` of one conversion batch on
    the card, K3 once on 8 rows (20 head frames a unit frame, 4 samples
    each), held against its plain version and the whole against the CPU."""
    from quickvc_tpu_torch.config import load_config

    with tempfile.TemporaryDirectory(prefix="qvc_sb_") as tmp:
        cfg = load_config(write_config(os.path.join(tmp, "sb.json"),
                                       os.path.join(ROOT, "configs", "quickvc.json"),
                                       model=ISTFT_MODEL))
    require(cfg.model.decoder_kind == "istft", "the single-band config")
    out = check_decoder_against_cpu(seeded_generator(cfg, SEED + 20),
                                    np.random.default_rng(SEED + 20), "single_band_decoder")
    require(out["k3_calls"] == [[BATCH, 20 * 100 + 5, 9, 16, 4]],
            f"single-band K3 calls {out['k3_calls']}")
    # K3's time on this head at the conversion's 5-s bucket, (8, 20 * 250 + 5, 9)
    from quickvc_tpu_torch.ops import fused_istft

    spec = 0.5 * torch.randn(BATCH, 18, 20 * 250 + 5, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(SEED + 20))
    lm, ph = spec.transpose(1, 2)[..., :9], spec.transpose(1, 2)[..., 9:]
    out["k3_conversion_shape"] = list(lm.shape)
    out["k3_device_ms"] = device_ms(lambda: fused_istft.polar_inverse_stft_kernel(lm, ph, 16, 4),
                                    only="polar_istft")
    print("single_band_k3 " + json.dumps({k: out[k] for k in ("k3_conversion_shape",
                                                              "k3_device_ms")}))
    return out


def check_mb_training(tmp: str, train: dict, train16: dict) -> dict:
    """The trainer CLI with the multiband decoder at ``precision: "bf16"``
    on phase 4's corpus (full width, batch 32, 512-frame crops, eval after
    update 1): ``loss/g/subband`` non-zero at every step in the event files,
    K4 and the LSTM stacks once a step, K1 and K3 twice a held-out item; its
    step walls beside the multistream bf16 run's of this call.

    The sub-band loss takes the log of the target bands' STFT magnitude with
    no floor, as the JAX package does (``quickvc_tpu/losses.py:45-51``), so
    a crop whose target is zero over a whole STFT window of a band (digital
    silence: the corpus's s16 lead-in and lead-out round to zero; or the
    masked tail past a short item's ``n_take``) gives +inf, and the guard
    skips that G update, as the JAX step's would. So every
    step's losses are finite or its update was skipped, and at least one
    step is finite and not skipped."""
    from quickvc_tpu_torch import ops

    hpfile = write_config(os.path.join(tmp, "train_config_mb_bf16.json"), train["hpfile"],
                          model=MB_MODEL, train={"precision": "bf16"})
    root = os.path.join(tmp, "logs_mb")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    summary = run_train(hpfile, root, BF16_TRAIN_STEPS)
    launches = ops.launch_counts()
    per_eval = 2 * len(EVAL_SECONDS)
    expected = {name: 0 for name in launches} | {
        "wave_to_spec_halo": BF16_TRAIN_STEPS, "wave_to_mel": per_eval,
        "polar_inverse_stft": per_eval, "lstm_stack_bf16": BF16_TRAIN_STEPS,
        "lstm_stack_bf16_backward": BF16_TRAIN_STEPS}
    events = read_events(os.path.join(root, "smoke"))
    subband = events["values"].get("loss/g/subband", {})
    losses = summary["losses"]
    timed = summary["step_seconds"][TRAIN_WARMUP:]
    out = {"steps": summary["steps"], "step_seconds": summary["step_seconds"],
           "mean_step_seconds": float(np.mean(timed)),
           "ms_bf16_mean_step_seconds": train16["mean_step_seconds"],
           "subband_loss": subband, "losses_last": losses[-1], "launches": launches,
           "expected_launches": expected}
    print("train_mb_bf16 " + json.dumps(out))
    finite = [bool(all(np.isfinite(v) for v in step.values())
                   and np.isfinite(subband.get(g, np.nan))) for g, step in enumerate(losses)]
    out["finite_steps"] = finite
    print("train_mb_bf16_steps " + json.dumps({"finite": finite,
                                               "skipped": [s["skipped"] for s in losses]}))
    require(summary["steps"] == BF16_TRAIN_STEPS == len(losses), "MB bf16 training steps")
    require(sorted(subband) == list(range(BF16_TRAIN_STEPS))
            and all(v > 0 for v in subband.values()),
            f"loss/g/subband non-zero at every step: {subband}")
    require(all(ok or step["skipped"] for ok, step in zip(finite, losses)),
            "every MB step finite or its update skipped by the guard")
    require(any(ok and not step["skipped"] for ok, step in zip(finite, losses)),
            "a finite MB step that updated")
    require(launches == expected, f"MB bf16 training launches {launches} != {expected}")
    return out


@functools.lru_cache(maxsize=None)
def _crc16_table() -> tuple[int, ...]:
    table = []
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        table.append(c)
    return tuple(table)


def _crc16(data: bytes) -> int:
    """FLAC's frame CRC-16 (polynomial 0x8005, MSB first, init 0)."""
    table, crc = _crc16_table(), 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ table[(crc >> 8) ^ b]
    return crc


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def write_flac(path: str, pcm: np.ndarray, sr: int, blocksize: int = 4096) -> None:
    """(N, C) int16 samples as a FLAC file of 16-bit verbatim subframes,
    independent channels, CRC-8 and CRC-16 computed, as
    ``tests/test_native_audio.py:encode_flac`` writes them."""
    n, c = pcm.shape
    # STREAMINFO: block sizes (16 + 16 bits), frame sizes unknown (24 + 24), rate
    # (20), channels - 1 (3), bits - 1 (5), samples a channel (36), MD5 unset
    info = (blocksize << 92 | blocksize << 76 | sr << 8 | (c - 1) << 5 | 15) << 36 | n
    out = bytearray(b"fLaC") + bytes([0x80, 0, 0, 34]) + info.to_bytes(18, "big") + bytes(16)
    for index, start in enumerate(range(0, n, blocksize)):
        block = pcm[start : start + blocksize]
        require(index < 128, "FLAC frame numbers here take one byte")
        head = bytes([0xFF, 0xF8, 0x70, (c - 1) << 4 | 4 << 1, index])
        head += (len(block) - 1).to_bytes(2, "big")
        head += bytes([_crc8(head)])
        body = b"".join(b"\x02" + block[:, ch].astype(">i2").tobytes() for ch in range(c))
        frame = head + body
        out += frame + _crc16(frame).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(out)


def check_flac(tmp: str, rng: np.random.Generator, train: dict) -> dict:
    """FLAC input on the card's machine: ``python -m
    quickvc_tpu_torch.downsample`` over 48 kHz FLACs and over the same
    samples as s16 WAVs (16 kHz outputs bit-equal), then the trainer for
    FLAC_TRAIN_STEPS steps from a list of 16 kHz FLAC entries with unit
    siblings (bucket lengths equal to the exact probe)."""
    from quickvc_tpu_torch import downsample, ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.data import native
    from quickvc_tpu_torch.data.dataset import UnitAudioSpecDataset
    from scipy.io import wavfile

    native.library()   # built at the first read (the dataset's), or here
    trees = {ext: os.path.join(tmp, f"raw_{ext}") for ext in ("flac", "wav")}
    for i, (seconds, channels) in enumerate(DOWNSAMPLE_INPUTS):
        pcm = np.stack([synth_voice(seconds, 48000, rng) for _ in range(channels)], axis=1)
        pcm = np.round(pcm * 32767).astype(np.int16)
        for ext, root in trees.items():
            os.makedirs(os.path.join(root, f"spk{i % 2}"), exist_ok=True)
            path = os.path.join(root, f"spk{i % 2}", f"utt{i}.{ext}")
            if ext == "flac":
                write_flac(path, pcm, 48000)
            else:
                wavfile.write(path, 48000, pcm)
    outs = {}
    for ext, root in trees.items():
        proc = subprocess.run([sys.executable, "-m", "quickvc_tpu_torch.downsample",
                               "--in-dir", root, "--out-dir", root + "_16k",
                               "--extension", f".{ext}", "--num-workers", "2"],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0, f"downsample over the {ext} tree: {proc.stderr[-2000:]}")
        outs[ext] = {}
        for _, dst in downsample.jobs_for(root, root + "_16k", f".{ext}"):
            with open(dst, "rb") as f:
                outs[ext][os.path.relpath(dst, root + "_16k")] = f.read()
    equal = sorted(outs["flac"]) == sorted(outs["wav"]) and all(
        outs["flac"][k] == outs["wav"][k] for k in outs["flac"])

    # a FLAC training list: 16 kHz s16 FLACs with unit siblings
    root = os.path.join(tmp, "flac_corpus")
    os.makedirs(root)
    paths = []
    for i, sec in enumerate(FLAC_SECONDS):
        wav = synth_voice(sec, SR, rng)
        path = os.path.join(root, f"utt{i}.flac")
        write_flac(path, np.round(wav * 32767).astype(np.int16)[:, None], SR)
        np.save(os.path.join(root, f"utt{i}.npy"),
                (0.5 * rng.standard_normal((len(wav) // 320, 256))).astype(np.float32))
        paths.append(path)
    listing = os.path.join(tmp, "flac_train.txt")
    with open(listing, "w") as f:
        f.write("\n".join(paths) + "\n")
    hpfile = write_config(os.path.join(tmp, "flac_config.json"), train["hpfile"],
                          train={"batch_size": len(FLAC_SECONDS), "eval_interval": 1000},
                          data={"training_files": listing})
    lengths = UnitAudioSpecDataset("train", load_config(hpfile), with_spec=False).lengths
    probed = sorted(native.probe(p)[0] // 320 for p in paths)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    summary = run_train(hpfile, os.path.join(tmp, "logs_flac"), FLAC_TRAIN_STEPS)
    launches = ops.launch_counts()
    out = {"downsample_files": len(outs["flac"]),
           "downsample_bit_equal": equal, "bucket_lengths": sorted(lengths),
           "probed_frames": probed, "steps": summary["steps"],
           "losses_last": summary["losses"][-1], "launches": launches}
    print("flac " + json.dumps(out))
    require(len(outs["flac"]) == len(DOWNSAMPLE_INPUTS) and equal,
            "downsample: the FLAC tree's 16 kHz outputs equal the WAV tree's")
    require(sorted(lengths) == probed, "FLAC bucket lengths are the exact probe's")
    require(summary["steps"] == FLAC_TRAIN_STEPS
            and all(np.isfinite(v) for s in summary["losses"] for v in s.values()),
            "finite losses from FLAC entries")
    require(launches["wave_to_spec_halo"] == FLAC_TRAIN_STEPS, "K4 once a FLAC step")
    return out


def check_msgpack_reader() -> dict:
    """The .msgpack reader imports on the card's machine (no msgpack or flax
    there) and decodes flax's layout: a map holding one float32 ndarray ext."""
    from quickvc_tpu_torch.utils.msgpack_params import unpackb

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    triple = b"\x93\x92\x02\x03\xa7float32\xc4" + bytes([w.nbytes]) + w.tobytes()
    data = b"\x81\xa1w\xc7" + bytes([len(triple), 1]) + triple
    got = unpackb(data)["w"]
    out = {"msgpack_imported": "msgpack" in sys.modules, "flax_imported": "flax" in sys.modules,
           "decoded": got.tolist()}
    print("msgpack_reader " + json.dumps(out))
    require(np.array_equal(got, w) and got.dtype == np.float32, "msgpack ndarray decoded")
    require(not out["msgpack_imported"] and not out["flax_imported"],
            "the reader needs neither msgpack nor flax")
    return out


# ---------------------------------------------------------------------------
# phase 16: data-parallel training across processes

DP_STEPS = 3                         # (a): the trainer under torchrun and the plain one
DP_RANKS = 2                         # (b): gloo ranks sharing the card
DP_RANK_BATCH = TRAIN_BATCH // DP_RANKS
# (b): (name, train config update, steps); each from the seeded weights
DP_VARIANTS = (("f32", {}, 2), ("bf16_reduce", {"grad_reduce_dtype": "bf16"}, 1),
               ("zero1", {"zero_opt_state": True}, 1), ("split_prior", {"split_prior": True}, 1))
DP_LOSSES = ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl",
             "loss/g/total")


def first_batch(cfg, rows: int) -> dict[str, np.ndarray]:
    """The first batch of ``rows`` the trainer's loader gives for ``cfg``'s corpus."""
    from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                                UnitAudioSpecDataset)

    ds = UnitAudioSpecDataset("train", cfg, with_spec=False)
    loader = DataLoader(ds, BucketSampler(ds.lengths, rows, BUCKET_BOUNDARIES), cfg,
                        num_workers=4, seed=cfg.train.seed)
    try:
        return {k: v.copy() for k, v in next(iter(loader)).items()}
    finally:
        loader.close()


def step_walls(log_path: str) -> list[float]:
    """The step walls a trainer's text log reports, in order."""
    import re

    with open(log_path) as f:
        return [float(x) for x in re.findall(r" step \d+ lr \S+ \|.*\((\S+) s\)", f.read())]


def torchrun(nproc: int, args: list[str], timeout: float = 600) -> tuple[float, str]:
    """``torchrun --standalone --nproc-per-node nproc ARGS`` from the checkout
    (ARGS: ``-m module ...``, or ``--no-python`` and a command); returns
    (seconds, stdout). Fails the run on a non-zero exit."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"torchrun {' '.join(args[:2])} exited "
            f"{proc.returncode}: {proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    return seconds, proc.stdout


# the trainer CLI on cuDNN's deterministic algorithms, for a run that is held
# bit for bit against another (the CLI itself leaves cuDNN free to pick them)
DETERMINISTIC_TRAINER = [
    "--no-python", sys.executable, "-c",
    "import sys, torch; torch.backends.cudnn.deterministic = True; "
    "from quickvc_tpu_torch.train.loop import main; main(sys.argv[1:])"]


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block: with the others two
    runs of the same step may sum in another order and differ in the last
    bits (a full-width float32 step: 330 of 466 G tensors, PERF.md)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def check_dp_world1(tmp: str, hpfile: str) -> dict:
    """(a) The trainer CLI under ``torchrun --nproc-per-node 1 ... --distributed``
    (NCCL, cuda:0) for DP_STEPS full-width steps at batch 32, and the plain
    trainer for as many in this process, both on cuDNN's deterministic
    algorithms: their ``G_3.pth`` and ``D_3.pth`` bit-equal, the step walls
    of both printed. (Phase 17 (a) times the step with cuDNN free beside the
    deterministic one.)"""
    hp = write_config(os.path.join(tmp, "dp_config.json"), hpfile, train={"eval_interval": 0})
    root = os.path.join(tmp, "logs_dp")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the torchrun child trains on the same card
    seconds, _ = torchrun(1, [*DETERMINISTIC_TRAINER, "-c", hp, "-m", "smoke", "-mr",
                              os.path.join(root, "nccl"), "--max-steps", str(DP_STEPS),
                              "--distributed"])
    with cudnn_deterministic():
        plain = run_train(hp, os.path.join(root, "plain"), DP_STEPS)
    equal = {}
    for k in "GD":
        a, b = (os.path.join(root, run, "smoke", f"{k}_{DP_STEPS}.pth")
                for run in ("nccl", "plain"))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            equal[k] = fa.read() == fb.read()
    out = {"steps": DP_STEPS, "batch": TRAIN_BATCH, "torchrun_seconds": seconds,
           "nccl_step_seconds": step_walls(os.path.join(root, "nccl", "smoke", "train.log")),
           "plain_step_seconds": plain["step_seconds"], "checkpoints_bit_equal": equal}
    print("dp_world1_nccl " + json.dumps(out))
    require(len(out["nccl_step_seconds"]) == DP_STEPS, "the torchrun trainer logged every step")
    require(all(equal.values()), f"torchrun's checkpoints equal the plain trainer's: {equal}")
    return out


def _dp_rank(rank: int, tmp: str, variants=DP_VARIANTS) -> None:
    """One of phase 16 (b)'s gloo ranks, a spawned process on card 0: each
    variant of ``variants`` from the seeded weights on this rank's rows, the
    first step with the case's draws, later ones with the trainer's per-rank
    generator; after every step the hash of its parameters, the step wall
    and K4's launches. Writes ``dp_rank{rank}.pt``; rank 0 also the first
    float32 step's reduced gradients."""
    import hashlib

    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.parallel.shard_step import rank_seed
    from quickvc_tpu_torch.scripts.dp_collectives import bf16_mean_check
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # as the one-process reference runs: what the gate allows is then the
    # reduction's, not cuDNN's choice of algorithm
    torch.backends.cudnn.deterministic = True
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS), LOCAL_RANK="0")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                                         rank=rank, world_size=DP_RANKS)
    try:
        case = torch.load(os.path.join(tmp, "dp_case.pt"), weights_only=False)
        rows = slice(rank * DP_RANK_BATCH, (rank + 1) * DP_RANK_BATCH)
        batch = {k: torch.from_numpy(v[rows].copy()).to(dev) for k, v in case["batch"].items()}
        eps_q = torch.from_numpy(case["eps_q"][rows].copy()).to(dev)
        ids = torch.from_numpy(case["ids"][rows].copy()).to(dev)
        out = {"variants": {}}
        for name, train, steps in variants:
            cfg = load_config(case["hpfile"])
            for k, v in train.items():
                setattr(cfg.train, k, v)
            state = create_train_state(cfg, dev)
            basis = mel_basis(cfg, dev)
            gen = torch.Generator(device=dev)
            rec = {"hashes": [], "wave_to_spec_halo": [], "step_seconds": [], "losses": []}
            for s in range(steps):
                first = s == 0
                gen.manual_seed(rank_seed(cfg.train.seed * 1_000_003 + s, rank))
                debug = first and name == "f32"
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                m = train_step(state, batch, basis, generator=gen,
                               eps_q=eps_q if first else None, ids_slice=ids if first else None,
                               debug_grads=debug)
                torch.cuda.synchronize()
                rec["step_seconds"].append(time.perf_counter() - t0)
                rec["wave_to_spec_halo"].append(ops.launch_counts()["wave_to_spec_halo"])
                rec["losses"].append({k: float(m[k]) for k in case["losses"]})
                h = hashlib.sha256()
                for p in list(state.net_g.parameters()) + list(state.net_d.parameters()):
                    h.update(p.detach().cpu().numpy().tobytes())
                rec["hashes"].append(h.hexdigest())
                if debug and rank == 0:
                    torch.save({k: ({n: g.cpu() for n, g in v.items()} if k.startswith("debug/")
                                    else v.cpu()) for k, v in m.items()},
                               os.path.join(tmp, "dp_step.pt"))
            out["variants"][name] = rec
        out["bf16_mean"] = bf16_mean_check(dev)
        torch.save(out, os.path.join(tmp, f"dp_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def check_dp_gloo_ranks(tmp: str, hpfile: str, variants=DP_VARIANTS, label="dp_gloo_ranks",
                        losses=DP_LOSSES, margin: int = 0) -> dict:
    """(b) Two gloo ranks sharing the card (spawned processes), DP_RANK_BATCH
    rows each of one full-width batch of 32 from phase 4's corpus: 2 float32
    data-parallel steps and 1 step each of the bf16 reduce, ZeRO-1 and
    split_prior. The ranks' parameters bit-equal after every step; K4 once
    a step on each rank; the first float32 step's reduced gradients and
    losses against one process on the whole batch of 32 with the same draws,
    both on cuDNN's deterministic algorithms (losses rtol 2e-4 / atol 1e-5,
    gradients max rel 2e-3 (PERF.md section 2) beyond twice what moving the
    posterior noise by 1e-6 of itself moves the one process's gradient: at
    full width a float32 change of the generator's activations that small
    flips leaky ReLUs at their kink, and the decoder's gradients move by up
    to ~1e-2 with it (PERF.md section 6), so summing 16 rows twice instead
    of 32 once is held to that); as a control, rank 0's own gradients on its
    16 rows, unreduced, must fail that gate in G and in D; the bf16 mean
    over the two ranks bit-equal to round_bf16(a + b) / 2. ``variants``,
    ``losses`` and the line's ``label`` default to phase 16's; the slice
    starts keep ``margin`` frames from the crop's edges (phase 17 (b): the
    multiband model's sub-band loss is +inf on the corpus's digital
    silence)."""
    import torch.multiprocessing as mp

    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    cfg = load_config(hpfile)
    batch = first_batch(cfg, TRAIN_BATCH)
    frames = batch["unit"].shape[1]
    rng = np.random.default_rng(SEED + 23)
    case = {"hpfile": hpfile, "batch": batch, "losses": losses,
            "eps_q": rng.standard_normal((TRAIN_BATCH, cfg.model.inter_channels, frames)
                                         ).astype(np.float32),
            "ids": rng.integers(margin, frames - cfg.segment_frames + 1 - margin, TRAIN_BATCH)}
    dp_tmp = os.path.join(tmp, label)
    os.makedirs(dp_tmp)
    torch.save(case, os.path.join(dp_tmp, "dp_case.pt"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the ranks share the card with this process
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_rank, args=(dp_tmp, variants), nprocs=DP_RANKS, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            require(time.perf_counter() - t0 < 600, f"{label}: the gloo ranks finished")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks_seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(dp_tmp, f"dp_rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]

    # one process on the whole batch, the same weights and draws; then twice
    # more with the posterior noise moved by 1e-6 of itself
    import copy

    dev = torch.device("cuda")
    base = create_train_state(cfg, dev)
    eps_q = torch.from_numpy(case["eps_q"]).to(dev)

    def one_process(eps, rows=slice(None)):
        state = create_train_state(cfg, dev, copy.deepcopy(base.net_g),
                                   copy.deepcopy(base.net_d))
        with cudnn_deterministic():
            return train_step(state, {k: torch.from_numpy(v[rows].copy()).to(dev)
                                      for k, v in batch.items()},
                              mel_basis(cfg, dev), eps_q=eps[rows],
                              ids_slice=torch.from_numpy(case["ids"][rows]).to(dev),
                              debug_grads=True)

    def maxrel(a, b) -> float:
        return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max().clamp(min=1e-12))

    m = one_process(eps_q)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    moved = [one_process(eps_q * (1 + 1e-6 * torch.randn(eps_q.shape, device=dev,
                                                           generator=gen))) for _ in range(2)]
    # the control: rank 0's own gradients, not reduced (a rank's dropped), which
    # the gate must refuse
    local = one_process(eps_q, slice(0, DP_RANK_BATCH))
    dp = torch.load(os.path.join(dp_tmp, "dp_step.pt"), weights_only=False)
    compared = {k: [float(dp[k]), float(m[k])] for k in losses}
    if "loss/g/subband" in losses:
        # what the reduce took before the ratio went global: the ranks' own ratios, averaged
        second = one_process(eps_q, slice(DP_RANK_BATCH, TRAIN_BATCH))
        compared["rank_local_mean_subband"] = [
            (float(local["loss/g/subband"]) + float(second["loss/g/subband"])) / 2,
            float(m["loss/g/subband"])]
    grad_err, grads_ok, control_refused = {}, True, True
    for which in ("debug/d_grads", "debug/g_grads"):
        ratios, errs, sens, control = {}, {}, {}, {}
        for n, g in m[which].items():
            errs[n] = maxrel(dp[which][n], g)
            sens[n] = max(maxrel(x[which][n], g) for x in moved)
            ratios[n] = errs[n] / (2e-3 + 2 * sens[n])
            control[n] = maxrel(local[which][n], g) / (2e-3 + 2 * sens[n])
        worst, touchy = max(ratios, key=ratios.get), max(sens, key=sens.get)
        grads_ok &= ratios[worst] < 1
        control_refused &= max(control.values()) >= 1
        grad_err[which] = {"max_rel_err": max(errs.values()), "at": max(errs, key=errs.get),
                           "worst_err_over_gate": ratios[worst], "worst_at": worst,
                           "worst_err": errs[worst], "worst_sensitivity": sens[worst],
                           "max_sensitivity": sens[touchy], "most_sensitive": touchy,
                           "tensors": len(errs),
                           "control_worst_err_over_gate": max(control.values()),
                           "control_tensors_refused": sum(v >= 1 for v in control.values())}
    by_name = {}
    for name, _, steps in variants:
        r0, r1 = (r["variants"][name] for r in ranks)
        by_name[name] = {"steps": steps, "ranks_bit_equal": r0["hashes"] == r1["hashes"],
                          "wave_to_spec_halo": [r0["wave_to_spec_halo"], r1["wave_to_spec_halo"]],
                          "step_seconds": [r0["step_seconds"], r1["step_seconds"]],
                          "losses_rank0": r0["losses"]}
    out = {"ranks": DP_RANKS, "rows_a_rank": DP_RANK_BATCH, "ranks_seconds": ranks_seconds,
           "variants": by_name, "dp_vs_one_process": {"losses": compared, "grads": grad_err},
           "bf16_mean": [r["bf16_mean"] for r in ranks]}
    print(f"{label} " + json.dumps(out))
    losses = {k: compared[k] for k in losses}
    for name, v in by_name.items():
        require(v["ranks_bit_equal"], f"{label} {name}: the ranks' parameters bit-equal")
        require(v["wave_to_spec_halo"] == [[1] * v["steps"]] * DP_RANKS,
                f"{label} {name}: K4 once a step on each rank")
        require(all(np.isfinite(x) for step in v["losses_rank0"] for x in step.values()),
                f"{label} {name}: finite losses")
    require(all(abs(a - b) <= 1e-5 + 2e-4 * abs(b) for a, b in losses.values()),
            f"{label}: the data-parallel losses match one process on the batch of 32")
    require(grads_ok, f"{label}: the reduced gradients match one process on the batch "
            "of 32 (2e-3 beyond what a 1e-6 change of the posterior noise moves them)")
    require(control_refused, f"{label}: the gate refuses one rank's unreduced gradients "
            "(G's and D's)")
    require(all(r["bit_equal_to_round_bf16_sum_over_2"] for r in out["bf16_mean"]),
            f"{label}: the bf16 mean over two gloo ranks is round_bf16(a + b) / 2")
    return out


def check_nccl_cards(tmp: str, hpfile: str) -> dict:
    """(c) NCCL across the cards of this machine, where there are two or
    more: ``quickvc_tpu_torch.scripts.dp_collectives`` (the all-reduce's
    bytes and CUDA-event time per network, float32, bf16 and ZeRO-1; the
    bf16 mean bit-exact at two ranks, its error against float32 at more) at
    two ranks and at every card, and the trainer CLI for DP_STEPS steps at
    batch 32 a card with its step walls. On one card it prints why it did
    not run; that is no pass."""
    n = torch.cuda.device_count()
    if n < 2:
        out = {"cards": n, "skipped": "one card: NCCL across cards needs two or more; "
                                     "not run, so not passed"}
        print("dp_nccl_cards " + json.dumps(out))
        return out
    out = {"cards": n, "collectives": {}}
    for ranks in sorted({2, n}):
        _, stdout = torchrun(ranks, ["-m", "quickvc_tpu_torch.scripts.dp_collectives"])
        line = [ln for ln in stdout.splitlines() if ln.startswith("dp_collectives ")]
        require(len(line) == 1, f"dp_collectives printed its line at {ranks} ranks")
        out["collectives"][ranks] = json.loads(line[0].split(" ", 1)[1])
    hp = write_config(os.path.join(tmp, "dp_cards_config.json"), hpfile,
                      train={"eval_interval": 0})
    run_dir = os.path.join(tmp, "logs_dp_cards", "smoke")
    seconds, _ = torchrun(n, ["-m", "quickvc_tpu_torch.train", "-c", hp, "-m", "smoke", "-mr",
                              os.path.dirname(run_dir), "--max-steps", str(DP_STEPS),
                              "--distributed"])
    out["trainer"] = {"steps": DP_STEPS, "batch_a_card": TRAIN_BATCH, "torchrun_seconds": seconds,
                      "step_seconds": {r: step_walls(os.path.join(
                          run_dir, "train.log" if r == 0 else f"train.rank{r}.log"))
                          for r in range(n)}}
    print("dp_nccl_cards " + json.dumps(out))
    require(out["collectives"][2]["bf16_mean"]["bit_equal_to_round_bf16_sum_over_2"],
            "phase 16 (c): the bf16 mean over two NCCL ranks is round_bf16(a + b) / 2")
    require(all(len(w) == DP_STEPS for w in out["trainer"]["step_seconds"].values()),
            "phase 16 (c): every rank logged every step")
    return out


def check_data_parallel(tmp: str, hpfile: str) -> dict:
    """Phase 16: (a), (b) and (c) on phase 4's corpus and config."""
    return {"world1_nccl": check_dp_world1(tmp, hpfile),
            "gloo_ranks": check_dp_gloo_ranks(tmp, hpfile),
            "nccl_cards": check_nccl_cards(tmp, hpfile)}


# ---------------------------------------------------------------------------
# phase 17: a bit-exact resume on the card, the sub-band loss under float32
# data parallelism, tensor parallelism at configs/quickvc_tp.json

F4_STEPS, F4_SPLIT = 4, 2      # (a): 4 straight steps against 2 + a resume + 2
# (a): timed steps, in turns: cuDNN free, deterministic algorithms, and cuDNN
# free with the reflect pads as F.pad (the port before --deterministic)
F4_TURNS = ("free", "det", "fpad", "fpad", "det", "free")
F3_MARGIN = 16                 # (b): slice starts this many frames off the crop's edges
F3_LOSSES = DP_LOSSES + ("loss/g/subband",)
# (c): configs/quickvc_tp.json's batch of 64 cut to 8 rows: three copies of
# the 4096-wide model share the card, and gloo stages every model-axis
# collective through host memory (at 16 rows a float32 TP step took 11.7-16.6 s on
# an H100)
TP_BATCH = 8
TP_MIN_CHANNELS = 256
TP_INFER_SHAPE = (2, 64)       # (c): infer's rows and unit frames
# (c): draws of the moved posterior noise behind each gradient's sensitivity.
# A gradient's largest move comes from a few leaky ReLUs flipping at their
# kink, and which flip depends on the draw. At batch 8 on an H100, with 2
# draws the TP step's float32 difference in dec.resblocks.1.convs1.0.weight_v
# stood at 2.5x its gate (that gradient's 2-draw move 0.073 of its 8-draw
# one); from the third draw on no gradient was past its gate, and from the
# fourth to the eighth the worst stayed at 0.49 of it (PERF.md)
TP_DRAWS = 4
# (c): faults planted in the tensor-parallel layers on the 1 x 2 gloo mesh,
# which the gates must refuse: the float32 step's gradient gate the first,
# infer's bound the second (infer's transposed convs take seeded biases of
# TP_UPS_BIAS: init_random_ zeroes every bias, and with it this fault)
TP_STEP_FAULT = "copy_without_all_reduce"
TP_INFER_FAULT = "row_bias_before_sum"
TP_UPS_BIAS = 0.1


@contextlib.contextmanager
def planted_fault(name: str):
    """Inside, a tensor-parallel layer is wrong in one place:
    "copy_without_all_reduce": ``Copy``'s backward leaves out the other model
    ranks' parts of a column-parallel layer's input gradient;
    "row_bias_before_sum": a row-parallel transposed conv adds its bias to
    each rank's partial output, so the sum over the ranks holds it model
    times."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.models.layers import conv
    from quickvc_tpu_torch.parallel import tp_layers

    if name == "copy_without_all_reduce":
        owner, attr = tp_layers.Copy, "backward"
        fault = staticmethod(lambda ctx, g: (g, None))
    elif name == "row_bias_before_sum":
        owner, attr = tp_layers._RowParallel, "forward"
        real = owner.forward

        def fault(self, x):
            if not self.tp_weight_sharded:
                return real(self, x)
            axis = self.tp_axis
            bias = tp_layers.Gather.apply(self.bias, 0, axis) if self.tp_bias_sharded else (
                self.bias)
            part = conv(F.conv_transpose1d, tp_layers.Scatter.apply(x, 1, axis), self.weight(),
                        bias, self.stride, self.padding, self.output_padding)
            return tp_layers.ReduceSum.apply(part, axis).to(x.dtype)
    else:
        raise ValueError(name)
    saved = owner.__dict__[attr]
    setattr(owner, attr, fault)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def bias_ups_(net) -> None:
    """Seeded biases of TP_UPS_BIAS's scale on G's transposed convs, the same
    on every device (drawn on the CPU)."""
    from quickvc_tpu_torch.models.layers import WNConvTranspose1d

    gen = torch.Generator().manual_seed(SEED + 28)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, WNConvTranspose1d):
                m.bias.copy_(TP_UPS_BIAS * torch.randn(m.bias.shape, generator=gen))


@contextlib.contextmanager
def torch_reflect_pad():
    """Inside, the step's reflect pads are ``F.pad(mode="reflect")``, as the
    port had them before ``dsp.stft.reflect_pad`` (whose flip/cat backward
    has a deterministic version on the card)."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.dsp import stft
    from quickvc_tpu_torch.models import discriminators, layers

    users = (stft, layers, discriminators)
    real = [m.reflect_pad for m in users]
    for m in users:
        m.reflect_pad = lambda y, left, right: F.pad(y, (left, right), mode="reflect")
    try:
        yield
    finally:
        for m, f in zip(users, real):
            m.reflect_pad = f


def _step_turns(hpfile: str) -> dict:
    """A full-width step of ``hpfile``'s precision timed in turns with
    cuDNN free, on deterministic algorithms (the trainer's
    ``--deterministic``) and with cuDNN free and ``F.pad``'s reflect pads
    (``torch_reflect_pad``), each mode warmed up once first; then, on the
    deterministic algorithms, the port's own kernels of the step launched
    twice on the same inputs: K4 on the batch and, at bf16, the speaker
    LSTM's forward and backward stacks (the encoder on the batch's mel)."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.dsp.stft import spec_to_mel
    from quickvc_tpu_torch.train.loop import _upload, deterministic_algorithms
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import decode_batch, mel_basis, train_step

    cfg = load_config(hpfile)
    dev = torch.device("cuda")
    batch = {k: _upload(v, dev) for k, v in first_batch(cfg, TRAIN_BATCH).items()}
    state = create_train_state(cfg, dev)
    basis = mel_basis(cfg, dev)
    gen = torch.Generator(device=dev)

    def step(mode: str) -> float:
        pads = torch_reflect_pad() if mode == "fpad" else contextlib.nullcontext()
        with deterministic_algorithms(mode == "det"), pads:
            gen.manual_seed(cfg.train.seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batch, basis, generator=gen)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    walls = {mode: [] for mode in F4_TURNS}
    for mode in walls:
        step(mode)
    for mode in F4_TURNS:
        walls[mode].append(step(mode))
    mean = {k: float(np.mean(v)) for k, v in walls.items()}
    out = {"turns": list(F4_TURNS), "step_seconds": walls, "mean_step_seconds": mean,
           "deterministic_cost": mean["det"] / mean["free"] - 1,
           "reflect_pad_cost": mean["free"] / mean["fpad"] - 1}
    with deterministic_algorithms(True):
        ops.reset_launch_counts()
        specs = [decode_batch(batch, cfg)[1] for _ in range(2)]
        out["k4_bit_equal"] = bool(torch.equal(*specs))
        if cfg.train.precision == "bf16":
            enc = state.net_g.enc_spk
            mel = spec_to_mel(specs[0], basis).bfloat16()

            def lstm():
                d = enc(mel)
                return [d, *torch.autograd.grad(d.float().square().sum(),
                                                 list(enc.lstm.parameters()))]

            a, b = lstm(), lstm()
            out["lstm_bit_equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
        out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    return out


def _f4_job(out_path: str, hpfiles: dict, root: str, part: str) -> None:
    """Phase 17 (a) in a process of its own, started with
    ``CUBLAS_WORKSPACE_CONFIG`` set (as the CLI sets it before anything
    touches the card): part "first" times the steps in turns and runs the
    trainer CLI with ``--deterministic`` for F4_STEPS straight steps and for
    F4_SPLIT, at each precision; part "resume" (a new process) resumes the
    split runs to F4_STEPS. Writes its walls to ``out_path``."""
    sys.path.insert(0, ROOT)
    from quickvc_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    runs = ((("straight", F4_STEPS), ("resumed", F4_SPLIT)) if part == "first"
            else (("resumed", F4_STEPS),))
    for precision, hp in hpfiles.items():
        if part == "first":
            out[f"{precision}_turns"] = _step_turns(hp)
        for name, steps in runs:
            s = loop.main(["-c", hp, "-m", name, "-mr", os.path.join(root, precision),
                           "--max-steps", str(steps), "--device", "cuda", "--deterministic"])
            out[f"{precision}_{name}_{steps}"] = {"steps": s["steps"],
                                                  "step_seconds": s["step_seconds"]}
    with open(out_path, "w") as f:
        json.dump(out, f)


def check_deterministic_resume(tmp: str, hpfile: str) -> dict:
    """(a) F4: a full-width step (phase 4's config, batch 32) at float32 and
    at bf16, timed in turns with cuDNN free and on deterministic algorithms;
    K4 and, at bf16, the LSTM stacks bit-equal from one launch to the next;
    then the trainer CLI with ``--deterministic``: F4_STEPS straight steps
    against F4_SPLIT steps and a resume in a new process to F4_STEPS, at
    each precision, ``G_4.pth`` and ``D_4.pth`` byte-equal."""
    hps = {p: write_config(os.path.join(tmp, f"f4_{p}.json"), hpfile,
                           train={"precision": p, "eval_interval": 0}) for p in ("f32", "bf16")}
    root = os.path.join(tmp, "logs_f4")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the job trains on the same card
    results, t0 = {}, time.perf_counter()
    for part in ("first", "resume"):
        path = os.path.join(tmp, f"f4_{part}.json")
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke._f4_job({path!r}, {hps!r}, "
                                   f"{root!r}, {part!r})"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0, f"phase 17 (a) {part} exited {proc.returncode}: "
                f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
        with open(path) as f:
            results |= json.load(f)
    equal = {}
    for p in hps:
        for k in "GD":
            a, b = (os.path.join(root, p, run, f"{k}_{F4_STEPS}.pth")
                    for run in ("straight", "resumed"))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                equal[f"{p}_{k}"] = fa.read() == fb.read()
    out = {"seconds": time.perf_counter() - t0, "checkpoints_byte_equal": equal} | results
    print("deterministic_resume " + json.dumps(out))
    require(all(equal.values()), f"phase 17 (a): --deterministic resumed runs byte-equal to "
            f"straight ones: {equal}")
    for p in hps:
        turns = results[f"{p}_turns"]
        require(turns["k4_bit_equal"], f"phase 17 (a) {p}: K4 bit-equal from launch to launch")
        require(p != "bf16" or turns["lstm_bit_equal"],
                "phase 17 (a): the LSTM stacks bit-equal from launch to launch")
    return out


def check_f3_subband(tmp: str, hpfile: str) -> dict:
    """(b) F3: the multiband model (full width, phase 4's corpus) on two gloo
    ranks sharing the card, float32 reduce, against one process on the
    batch of 32 by phase 16 (b)'s gate, whose control (rank 0's unreduced
    gradients) it must refuse; the sub-band loss among the losses, and
    beside it the mean of the ranks' own ratios (what the reduce took
    before), printed."""
    hp = write_config(os.path.join(tmp, "f3_mb_config.json"), hpfile, model=MB_MODEL,
                      train={"eval_interval": 0})
    return check_dp_gloo_ranks(tmp, hp, variants=(("f32", {}, 1),), label="f3_mb_gloo_ranks",
                               losses=F3_LOSSES, margin=F3_MARGIN)


def _tp_rank(rank: int, tmp: str, world: int, data: int, model: int, backend: str,
             faults: bool) -> None:
    """One rank of phase 17 (c), a spawned process: gloo on card 0, or NCCL
    on card ``rank``. For each precision: the (data, model) TP state of the
    case's config from the seeded weights; a step on this data index's rows
    with the case's draws (rank 0 saves the metrics and gathered gradients);
    at the config's own bf16 a second step with the trainer's draws (seeded
    by the data index) for its wall, its model-axis collectives and the
    launches; the bytes this rank holds and its peak memory; the hash of its
    replicated parameters. Then ``infer`` of the sharded G, its transposed
    convs' biases seeded (rank 0 saves the wave). With ``faults``, the
    float32 step again from the same weights with TP_STEP_FAULT planted,
    and ``infer`` again with TP_INFER_FAULT (rank 0 saves both)."""
    import copy
    import hashlib

    sys.path.insert(0, ROOT)
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.parallel import tp, tp_layers
    from quickvc_tpu_torch.train.state import build_models, create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step
    from quickvc_tpu_torch.utils.weights import init_random_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True   # as the replicated reference runs
    card = rank if backend == "nccl" else 0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(card))
    torch.cuda.set_device(card)
    dev = torch.device("cuda", card)
    torch.distributed.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                                         rank=rank, world_size=world)
    try:
        case = torch.load(os.path.join(tmp, "tp_case.pt"), weights_only=False)
        mesh = tp.mesh_2d(data, model)
        rows = tp.batch_rows(mesh, case["eps_q"].shape[0])
        batch = {k: torch.from_numpy(v[rows].copy()).to(dev) for k, v in case["batch"].items()}
        eps_q = torch.from_numpy(case["eps_q"][rows].copy()).to(dev)
        ids = torch.from_numpy(case["ids"][rows].copy()).to(dev)
        cfg = load_config(case["hpfile"])
        whole = dict(zip("gd", build_models(cfg)))
        init_random_(whole["g"], cfg.train.seed)
        init_random_(whole["d"], cfg.train.seed + 1)
        out = {"mesh": [mesh.data_rank, mesh.model_rank], "card": card, "steps": {}}
        for precision in ("f32", "bf16"):
            cfg.train.precision = precision
            torch.cuda.reset_peak_memory_stats(dev)
            state = create_train_state(cfg, dev, copy.deepcopy(whole["g"]),
                                       copy.deepcopy(whole["d"]), tp=(mesh, TP_MIN_CHANNELS))
            basis = mel_basis(cfg, dev)
            rec = {}
            params = [p for net in (state.net_g, state.net_d) for p in net.parameters()]
            start = [p.detach().cpu() for p in params] if faults and precision == "f32" else []
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(state, batch, basis, eps_q=eps_q, ids_slice=ids, debug_grads=True)
            torch.cuda.synchronize()
            rec["checked_step_seconds"] = time.perf_counter() - t0
            rec["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
            if rank == 0:
                torch.save({k: ({n: g.cpu() for n, g in v.items()} if k.startswith("debug/")
                                else v.cpu()) for k, v in m.items()},
                           os.path.join(tmp, f"tp_{precision}.pt"))
            del m
            if precision == "bf16":
                gen = torch.Generator(device=dev).manual_seed(
                    tp.step_seed(cfg.train.seed * 1_000_003 + 1, mesh))
                ops.reset_launch_counts()
                tp_layers.reset_stats()
                torch.cuda.synchronize()
                torch.distributed.barrier()   # rank 0 was saving: start the wall together
                t0 = time.perf_counter()
                m = train_step(state, batch, basis, generator=gen)
                torch.cuda.synchronize()
                rec["step_seconds"] = time.perf_counter() - t0
                rec["collectives"] = {k: dict(v) for k, v in tp_layers.STATS.items()}
                rec["launches_second"] = {k: v for k, v in ops.launch_counts().items() if v}
                rec["losses_second"] = {k: float(m[k]) for k in DP_LOSSES}
                del m
            rec["bytes"] = {k: tp.local_bytes(*state.nets(k)[:2]) for k in "gd"}
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
            h = hashlib.sha256()
            for net in (state.net_g, state.net_d):
                for n, p in net.named_parameters():
                    if net.tp_layout[n] is None:
                        h.update(p.detach().cpu().numpy().tobytes())
            rec["replicated_hash"] = h.hexdigest()
            if start:   # the first step again from its weights (held on the host), faulted
                with torch.no_grad():
                    for p, v in zip(params, start):
                        p.copy_(v)
                del start
                with planted_fault(TP_STEP_FAULT):
                    m = train_step(state, batch, basis, eps_q=eps_q, ids_slice=ids,
                                   debug_grads=True)
                if rank == 0:
                    torch.save({k: {n: g.cpu() for n, g in v.items()} for k, v in m.items()
                                if k.startswith("debug/")}, os.path.join(tmp, "tp_fault.pt"))
                del m
            out["steps"][precision] = rec
            del state, params
            torch.cuda.empty_cache()
        net = whole["g"].to(dev).eval()
        bias_ups_(net)
        tp_layers.shard_modules_(net, tp.param_layout(net, model, TP_MIN_CHANNELS),
                                 mesh.model_axis)

        def infer():
            with torch.inference_mode():
                return net.infer(case["infer_unit"].to(dev), case["infer_g"].to(dev),
                                 noise_scale=0.667,
                                 generator=torch.Generator(device=dev).manual_seed(SEED + 26))

        ops.reset_launch_counts()
        y = infer()
        out["infer_launches"] = {k: v for k, v in ops.launch_counts().items() if v}
        if rank == 0:
            torch.save(y.cpu(), os.path.join(tmp, "tp_infer.pt"))
        if faults:
            with planted_fault(TP_INFER_FAULT):
                y = infer()
            if rank == 0:
                torch.save(y.cpu(), os.path.join(tmp, "tp_infer_fault.pt"))
        torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _tp_reference(case: dict, cfg) -> dict:
    """The replicated one-process steps and ``infer`` of phase 17 (c), on
    deterministic cuDNN, from the seeded weights: float32 on the batch with
    the case's draws (its losses and gradients, on the host), TP_DRAWS times
    more with the posterior noise moved by 1e-6 of itself (each gradient's
    largest relative move: its sensitivity), on the first half of the rows
    (the control), and at bf16."""
    import copy

    from quickvc_tpu_torch.train.state import build_models, create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step
    from quickvc_tpu_torch.utils.weights import init_random_

    dev = torch.device("cuda")
    whole = dict(zip("gd", build_models(cfg)))
    init_random_(whole["g"], cfg.train.seed)
    init_random_(whole["d"], cfg.train.seed + 1)
    whole = {k: v.to(dev) for k, v in whole.items()}   # each run starts from a copy on the card
    eps_q = torch.from_numpy(case["eps_q"]).to(dev)
    walls = {}

    def run(label: str, precision: str, eps: torch.Tensor, rows=slice(None)) -> dict:
        cfg.train.precision = precision
        state = create_train_state(cfg, dev, copy.deepcopy(whole["g"]), copy.deepcopy(whole["d"]))
        batch = {k: torch.from_numpy(v[rows].copy()).to(dev) for k, v in case["batch"].items()}
        with cudnn_deterministic():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(state, batch, mel_basis(cfg, dev), eps_q=eps[rows],
                           ids_slice=torch.from_numpy(case["ids"][rows].copy()).to(dev),
                           debug_grads=True)
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
        out = {k: ({n: g.cpu() for n, g in v.items()} if k.startswith("debug/") else v.cpu())
               for k, v in m.items()}
        del state, m
        torch.cuda.empty_cache()
        return out

    def maxrel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    ref = {"f32": run("f32", "f32", eps_q)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    sens = {which: dict.fromkeys(ref["f32"][which], 0.0)
            for which in ("debug/d_grads", "debug/g_grads")}
    for i in range(TP_DRAWS):
        moved = run(f"f32_moved_{i}", "f32", eps_q * (1 + 1e-6 * torch.randn(
            eps_q.shape, device=dev, generator=gen)))
        for which, s in sens.items():
            for n, g in ref["f32"][which].items():
                s[n] = max(s[n], maxrel(moved[which][n], g))
        del moved
    half = run("f32_half_rows", "f32", eps_q, slice(0, TP_BATCH // 2))
    control = {which: {n: maxrel(half[which][n], g) for n, g in ref["f32"][which].items()}
               for which in sens}
    del half
    ref["bf16"] = run("bf16", "bf16", eps_q)
    cfg.train.precision = "f32"
    net = whole["g"].eval()
    bias_ups_(net)
    with torch.inference_mode():
        y = net.infer(case["infer_unit"].to(dev), case["infer_g"].to(dev), noise_scale=0.667,
                      generator=torch.Generator(device=dev).manual_seed(SEED + 26)).cpu()
    params = {k: sum(p.numel() * p.element_size() for p in whole[k].parameters()) for k in "gd"}
    del net, whole
    torch.cuda.empty_cache()
    return {"steps": ref, "sensitivity": sens, "control": control, "infer": y, "walls": walls,
            "param_bytes": params}


def _compare_tp(ref: dict, tp_m: dict, tp_infer: torch.Tensor) -> dict:
    """Phase 17 (c)'s gates for one TP run: the float32 step against the
    replicated one (losses rtol 2e-4 / atol 1e-5; each gradient's max rel
    error under 2e-3 + 2x its sensitivity, and the control refused by that
    gate in G and in D), the bf16 step by PERF.md section 2's bf16 rules
    against the replicated bf16 and float32 steps, ``infer`` within 1e-3 x
    peak."""
    def maxrel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    r32, r16 = ref["steps"]["f32"], ref["steps"]["bf16"]
    out = {"f32": {"losses": {k: [float(tp_m["f32"][k]), float(r32[k])] for k in DP_LOSSES},
                   "grads": {}},
           "bf16": {"losses": {}, "grads": {}}}
    out["f32"]["losses_ok"] = all(abs(a - b) <= 1e-5 + 2e-4 * abs(b)
                                  for a, b in out["f32"]["losses"].values())
    ok32, refused, ok16 = True, True, True
    for which in ("debug/d_grads", "debug/g_grads"):
        ratios, control = {}, {}
        for n, g in r32[which].items():
            gate = 2e-3 + 2 * ref["sensitivity"][which][n]
            ratios[n] = maxrel(tp_m["f32"][which][n], g) / gate
            control[n] = ref["control"][which][n] / gate
        worst = max(ratios, key=ratios.get)
        ok32 &= ratios[worst] < 1
        refused &= max(control.values()) >= 1
        out["f32"]["grads"][which] = {
            "worst_err_over_gate": ratios[worst], "worst_at": worst,
            "worst_sensitivity": ref["sensitivity"][which][worst], "tensors": len(ratios),
            "control_worst_err_over_gate": max(control.values()),
            "control_tensors_refused": sum(v >= 1 for v in control.values())}
        bf_ratios = {n: maxrel(tp_m["bf16"][which][n], g)
                     / max(2 * maxrel(g, r32[which][n]), 2e-2)
                     for n, g in r16[which].items()}
        worst16 = max(bf_ratios, key=bf_ratios.get)
        ok16 &= bf_ratios[worst16] <= 1
        out["bf16"]["grads"][which] = {"worst_err_over_bound": bf_ratios[worst16],
                                       "worst_at": worst16}
    for k in DP_LOSSES:
        a, b, b32 = float(tp_m["bf16"][k]), float(r16[k]), float(r32[k])
        bound = max(2 * abs(b - b32), 4e-3 * abs(b32))
        out["bf16"]["losses"][k] = [a, b, b32, bound]
        ok16 &= abs(a - b) <= bound
    peak = float(ref["infer"].abs().max())
    out["infer"] = {"max_abs_err": float((tp_infer - ref["infer"]).abs().max()), "peak": peak,
                    "shape": list(tp_infer.shape)}
    out["ok"] = {"f32_losses": out["f32"]["losses_ok"], "f32_grads": ok32,
                 "control_refused": refused, "bf16": ok16,
                 "infer": out["infer"]["max_abs_err"] <= 1e-3 * peak}
    return out


def _fault_checks(ref: dict, run: dict) -> dict:
    """The planted faults against phase 17 (c)'s gates: each gradient of
    the float32 step with TP_STEP_FAULT over its gate (2e-3 + 2x its
    sensitivity; a non-finite error counts as past it), and ``infer`` with
    TP_INFER_FAULT against infer's bound (1e-3 x peak)."""
    def over_gate(a, b, sens) -> float:
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
        return err / (2e-3 + 2 * sens) if np.isfinite(err) else float("inf")

    out = {"step_fault": TP_STEP_FAULT, "infer_fault": TP_INFER_FAULT}
    for which in ("debug/d_grads", "debug/g_grads"):
        ratios = {n: over_gate(run["fault"][which][n], g, ref["sensitivity"][which][n])
                  for n, g in ref["steps"]["f32"][which].items()}
        worst = max(ratios, key=ratios.get)
        out[which] = {"worst_err_over_gate": ratios[worst], "worst_at": worst,
                      "tensors_refused": sum(v >= 1 for v in ratios.values()),
                      "tensors": len(ratios)}
    peak = float(ref["infer"].abs().max())
    out["infer_max_abs_err"] = float((run["infer_fault"] - ref["infer"]).abs().max())
    out["infer_err_over_bound"] = out["infer_max_abs_err"] / (1e-3 * peak)
    out["ok"] = {"step_fault_refused": any(out[w]["tensors_refused"] for w in
                                           ("debug/d_grads", "debug/g_grads")),
                 "infer_fault_refused": out["infer_err_over_bound"] > 1}
    return out


def _run_tp(tmp: str, case: dict, backend: str, data: int, model: int,
            faults: bool = False) -> dict:
    """Phase 17 (c)'s ranks on one (data, model) mesh: their records and
    rank 0's saved step metrics and infer wave, and with ``faults`` the
    faulted step's gradients and infer wave."""
    import torch.multiprocessing as mp

    world = data * model
    run_tmp = os.path.join(tmp, f"tp_{backend}_{data}x{model}")
    os.makedirs(run_tmp)
    torch.save(case, os.path.join(run_tmp, "tp_case.pt"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_tp_rank, args=(run_tmp, world, data, model, backend, faults),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            require(time.perf_counter() - t0 < 900, f"phase 17 (c) {backend} {data}x{model}: "
                    "the ranks finished")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = [torch.load(os.path.join(run_tmp, f"tp_rank{r}.pt"), weights_only=False)
             for r in range(world)]
    metrics = {p: torch.load(os.path.join(run_tmp, f"tp_{p}.pt"), weights_only=False)
               for p in ("f32", "bf16")}
    out = {"seconds": time.perf_counter() - t0, "ranks": ranks, "metrics": metrics}
    for k, f in (("infer", "tp_infer.pt"), ("fault", "tp_fault.pt"),
                 ("infer_fault", "tp_infer_fault.pt"))[: 1 + 2 * faults]:
        out[k] = torch.load(os.path.join(run_tmp, f), weights_only=False)
    return out


def check_tensor_parallel(tmp: str, hpfile: str) -> dict:
    """(c) Tensor parallelism at ``configs/quickvc_tp.json`` (upsample 4096,
    bf16; its batch cut to TP_BATCH rows of phase 4's corpus): two gloo ranks
    on card 0 as a 1 x 2 (data, model) mesh; with two cards or more also
    NCCL at 1 x 2, and 2 x 2 on four. Each run's float32 step, bf16 step and
    ``infer`` against the replicated ones (``_compare_tp``), on the gloo mesh
    the planted faults refused by the same gates (``_fault_checks``); the model
    ranks' replicated parameters bit-equal (after one float32 step and two
    bf16 steps, the second drawing from the data index's seed); K4 once a step
    on every rank, at bf16 the LSTM stacks once a step, K3 once in every
    rank's ``infer``; the bytes of parameters and moments a rank against
    replicated, its peak memory, step walls and model-axis collectives."""
    from quickvc_tpu_torch.config import load_config

    with open(hpfile) as f:
        data_section = json.load(f)["data"]
    hp = write_config(os.path.join(tmp, "tp_config.json"),
                      os.path.join(ROOT, "configs", "quickvc_tp.json"),
                      train={"batch_size": TP_BATCH, "precision": "f32", "max_speclen": 512,
                             "transfer": "compact", "loader_workers": 4, "log_interval": 1,
                             "eval_interval": 0},
                      data={k: data_section[k] for k in ("training_files", "validation_files")})
    cfg = load_config(hp)
    batch = first_batch(cfg, TP_BATCH)
    frames = batch["unit"].shape[1]
    rng = np.random.default_rng(SEED + 25)
    rows, unit_frames = TP_INFER_SHAPE
    g_vec = rng.standard_normal((rows, cfg.model.gin_channels)).astype(np.float32)
    case = {"hpfile": hp, "batch": batch,
            "eps_q": rng.standard_normal((TP_BATCH, cfg.model.inter_channels, frames)
                                         ).astype(np.float32),
            "ids": rng.integers(0, frames - cfg.segment_frames + 1, TP_BATCH),
            "infer_unit": torch.from_numpy(0.5 * rng.standard_normal(
                (rows, cfg.model.unit_channels, unit_frames)).astype(np.float32)),
            "infer_g": torch.from_numpy(g_vec / np.linalg.norm(g_vec, axis=1, keepdims=True))}
    t0 = time.perf_counter()
    ref = _tp_reference(case, cfg)
    ref_seconds = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    meshes = [("gloo", 1, 2)] + [("nccl", 1, 2)] * (cards >= 2) + [("nccl", 2, 2)] * (cards >= 4)
    out = {"config": "configs/quickvc_tp.json", "batch": TP_BATCH, "cut": f"batch 64 -> {TP_BATCH}",
           "min_channels": TP_MIN_CHANNELS, "reference_seconds": ref_seconds,
           "reference_walls": ref["walls"], "replicated_param_bytes": ref["param_bytes"],
           "runs": {}}
    launches = {}
    for backend, data, model in meshes:
        faults = (backend, data, model) == meshes[0]
        run = _run_tp(tmp, case, backend, data, model, faults)
        name = f"{backend}_{data}x{model}"
        checks = _compare_tp(ref, run["metrics"], run["infer"])
        if faults:
            checks["planted_faults"] = _fault_checks(ref, run)
            checks["ok"] |= checks["planted_faults"]["ok"]
        ranks = run["ranks"]
        rec = {"seconds": run["seconds"], "checks": checks, "ranks": {}}
        for r in ranks:
            rec["ranks"][r["mesh"][0] * model + r["mesh"][1]] = {
                "card": r["card"], "infer_launches": r["infer_launches"],
                "steps": {p: {k: v for k, v in s.items() if k != "replicated_hash"}
                          for p, s in r["steps"].items()}}
        hashes = {p: {r["steps"][p]["replicated_hash"] for r in ranks} for p in ("f32", "bf16")}
        rec["replicated_bit_equal"] = {p: len(h) == 1 for p, h in hashes.items()}
        out["runs"][name] = rec
        print(f"tp_{name} " + json.dumps(rec))
        launches[name] = {"wave_to_spec_halo": [[r["steps"][p]["launches"].get(
                              "wave_to_spec_halo", 0) for r in ranks] for p in ("f32", "bf16")],
                          "polar_inverse_stft": [r["infer_launches"].get("polar_inverse_stft", 0)
                                                 for r in ranks],
                          "lstm_stack_bf16": [r["steps"]["bf16"]["launches"].get(
                              "lstm_stack_bf16", 0) for r in ranks],
                          "lstm_stack_bf16_backward": [r["steps"]["bf16"]["launches"].get(
                              "lstm_stack_bf16_backward", 0) for r in ranks]}
        for k, ok in checks["ok"].items():
            require(ok, f"phase 17 (c) {name}: {k}")
        require(all(rec["replicated_bit_equal"].values()),
                f"phase 17 (c) {name}: the model ranks' replicated parameters bit-equal")
        for r in ranks:
            for p, s in r["steps"].items():
                for which in ("launches", "launches_second")[: 1 + (p == "bf16")]:
                    require(s[which].get("wave_to_spec_halo") == 1,
                            f"phase 17 (c) {name} {p}: K4 once a step on every rank")
                    want = 1 if p == "bf16" else 0
                    require(s[which].get("lstm_stack_bf16", 0) == want
                            and s[which].get("lstm_stack_bf16_backward", 0) == want,
                            f"phase 17 (c) {name} {p}: the LSTM stacks once a bf16 step")
                for k in "gd":
                    require(s["bytes"][k]["params"] < ref["param_bytes"][k],
                            f"phase 17 (c) {name}: a rank holds less of {k} than replicated")
            require(r["infer_launches"].get("polar_inverse_stft") == 1,
                    f"phase 17 (c) {name}: K3 once in every rank's infer")
    out["launches"] = launches
    print("tensor_parallel " + json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


def check_phase17(tmp: str, hpfile: str) -> dict:
    """Phase 17: (a), (b) and (c) on phase 4's corpus."""
    out = {"deterministic_resume": check_deterministic_resume(tmp, hpfile)}
    mark("phase17_a")
    out["f3_subband"] = check_f3_subband(tmp, hpfile)
    mark("phase17_b")
    out["tensor_parallel"] = check_tensor_parallel(tmp, hpfile)
    mark("phase17_c")
    return out


# ---------------------------------------------------------------------------
# phase 18: the profiling harness (the trainer's --profile-steps, timed,
# time_chained) and the parameter exporter

PROFILE_MAX_STEPS, PROFILE_STEPS = 7, 2   # (a): counters 5 and 6 traced
PROFILE_ITERS = 20                        # (b): runs a timing


def trace_records(path: str) -> dict:
    """What one Chrome trace holds: its host-side ``quickvc_train_step``
    spans, the device records of the port's kernels by function, and how
    its kernel launches (runtime and driver calls) match kernel records by
    CUPTI's correlation id: the launches left without a record (with their
    offset from the first step span's start, in ms) and the host-to-device
    delay of the matched ones (the device record's start minus the
    launch's, in us; negative only through the clocks' conversion)."""
    from quickvc_tpu_torch.train.step import STEP_SPAN

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted(e["ts"] for e in events
                   if e.get("name") == STEP_SPAN and e.get("cat") == "user_annotation")
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "") and "correlation" in e.get("args", {})]
    by_corr = {e["args"]["correlation"]: e for e in kernels if "correlation" in e.get("args", {})}
    delays = sorted(by_corr[e["args"]["correlation"]]["ts"] - e["ts"] for e in launches
                    if e["args"]["correlation"] in by_corr)
    missing = [e for e in launches if e["args"]["correlation"] not in by_corr]
    names = [e["name"] for e in kernels]
    return {"bytes": os.path.getsize(path), "step_spans": len(spans),
            "kernel_records": len(kernels), "kernel_launches": len(launches),
            "launches_without_record": len(missing),
            "missing_after_first_span_ms": [round((e["ts"] - spans[0]) / 1e3, 3)
                                            for e in missing[:50]] if spans else [],
            "launch_to_kernel_us": {"min": delays[0], "median": delays[len(delays) // 2]}
            if delays else None,
            "port_kernels": {fn: sum(fn in k for k in names) for fn in DEVICE_FUNCTIONS
                             if any(fn in k for k in names)}}


def check_profile_steps(tmp: str, hpfile: str) -> dict:
    """(a) The trainer CLI at bf16 with ``--profile-steps``: one trace file,
    a step span and a K4 record for each traced step; the LSTM stacks'
    records printed beside what the launch counters say the window ran."""
    import glob

    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.train import loop

    hp = write_config(os.path.join(tmp, "profile_config.json"), hpfile,
                      train={"precision": "bf16", "eval_interval": 0})
    root = os.path.join(tmp, "logs_profile")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = loop.main(["-c", hp, "-m", "smoke", "-mr", root, "--max-steps",
                         str(PROFILE_MAX_STEPS), "--device", "cuda", "--profile-steps",
                         str(PROFILE_STEPS)])
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    paths = glob.glob(os.path.join(root, "smoke", "profile", "*.pt.trace.json"))
    require(len(paths) == 1, f"phase 18 (a): one trace file, found {paths}")
    rec = trace_records(paths[0])
    walls = summary["step_seconds"]
    lo, hi = 5, 5 + PROFILE_STEPS
    per_step = {k: v / PROFILE_MAX_STEPS for k, v in launches.items()}
    out = {"steps": summary["steps"], "profile_steps": PROFILE_STEPS, "cli_seconds": seconds,
           "trace": rec, "launches": launches,
           "window_launches": {k: v * PROFILE_STEPS for k, v in per_step.items()},
           "traced_step_seconds": walls[lo:hi], "untraced_step_seconds": walls[TRAIN_WARMUP:lo],
           "traced_over_untraced": float(np.mean(walls[lo:hi]) / np.mean(walls[TRAIN_WARMUP:lo])),
           "lstm_records": {fn: [rec["port_kernels"].get(fn, 0), PROFILE_STEPS]
                            for fn in ("lstm_stack_kernel", "lstm_stack_backward_kernel")},
           "no_profile_dir_without_the_flag": {
               run: not os.path.exists(os.path.join(tmp, run, "smoke", "profile"))
               for run in ("logs", "logs_bf16")}}
    print("profile_steps " + json.dumps(out))
    require(summary["steps"] == PROFILE_MAX_STEPS, "phase 18 (a): every step taken")
    require(rec["step_spans"] == PROFILE_STEPS,
            f"phase 18 (a): {PROFILE_STEPS} step spans in the trace, {rec['step_spans']} found")
    require(rec["port_kernels"].get("wave_to_spec_halo_kernel") == PROFILE_STEPS,
            f"phase 18 (a): K4 once a traced step in the trace: {rec['port_kernels']}")
    require(launches == {"wave_to_spec_halo": PROFILE_MAX_STEPS,
                         "lstm_stack_bf16": PROFILE_MAX_STEPS,
                         "lstm_stack_bf16_backward": PROFILE_MAX_STEPS},
            f"phase 18 (a): launches {launches}")
    require(all(out["no_profile_dir_without_the_flag"].values()),
            "phase 18 (a): a run without --profile-steps wrote a profile/ directory")
    return out


def check_timing_harness(k4_ms: float) -> dict:
    """(b) ``timed`` and ``time_chained`` on K4 at phase 4's batch, beside
    phase 1's CUDA-event time of K4 (``ms``); ``time_chained``'s runs each
    launch K4 once, each on the last run's carry."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.ops import fused_mel
    from quickvc_tpu_torch.utils.profiling import time_chained, timed

    rng = np.random.default_rng(SEED + 28)
    t_len = 512 * 320 + 960
    wave = torch.from_numpy((np.round(np.clip(rng.standard_normal((TRAIN_BATCH, t_len)) * 0.1,
                                              -1, 1) * 32767) / 32768.0).astype(np.float32)).cuda()

    def k4(w):
        return fused_mel.wave_to_spec_halo_kernel(w, 1280, 320, 1280)

    seconds, _ = timed(k4, wave, iters=PROFILE_ITERS)
    ops.reset_launch_counts()
    chained = time_chained(lambda c, w: k4(w + c), PROFILE_ITERS, wave)
    launches = ops.launch_counts()["wave_to_spec_halo"]
    out = {"shape": list(wave.shape), "iters": PROFILE_ITERS,
           "timed_ms": seconds / PROFILE_ITERS * 1e3,
           "time_chained_ms": chained / PROFILE_ITERS * 1e3, "phase1_events_ms": k4_ms,
           "time_chained_launches": launches}
    print("timing_harness " + json.dumps(out))
    # one untimed pass and two timed ones
    require(launches == 3 * PROFILE_ITERS,
            f"phase 18 (b): time_chained launched K4 {launches} times, not {3 * PROFILE_ITERS}")
    return out


def check_export(tmp: str, hpfile: str, files, n_frames) -> dict:
    """(c) The exporter on phase 4's newest checkpoint pair and phase 2's
    HuBERT, in this process: no ``msgpack`` or ``flax`` module imported;
    the ``.msgpack`` files read back bit-equal to the checkpoints, the
    ``--format torch`` files equal to them without the decoder's buffer and
    with no optimizer state; the conversion CLI from the ``.msgpack`` files
    against the ``.pth`` route's, K1, K2 and K3 launched the same."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.data.audio_io import read_wav
    from quickvc_tpu_torch.scripts import export_params
    from quickvc_tpu_torch.utils.checkpoint import latest_step
    from quickvc_tpu_torch.utils.msgpack_params import load_params
    from quickvc_tpu_torch.utils.weights import (generator_state_dict_from_jax,
                                                 hubert_state_dict_from_jax)

    run_dir = os.path.join(tmp, "logs", "smoke")
    step = latest_step(run_dir)
    out_dir = os.path.join(tmp, "export")
    os.makedirs(out_dir)
    path = {k: os.path.join(out_dir, k) for k in ("g.msgpack", "hubert.msgpack", "G.pth", "D.pth")}
    walls = {}
    for name, argv in (("msgpack", ["--model-dir", run_dir, "--out", path["g.msgpack"]]),
                       ("torch", ["--model-dir", run_dir, "--format", "torch", "--out",
                                  path["G.pth"], "--disc-out", path["D.pth"]]),
                       ("hubert", ["--hubert-in", files[2], "--hubert-out",
                                   path["hubert.msgpack"]])):
        t0 = time.perf_counter()
        export_params.main(argv)
        walls[name] = time.perf_counter() - t0
    imported = sorted(m for m in sys.modules if m.split(".")[0] in ("msgpack", "flax"))

    cfg = load_config(os.path.join(run_dir, "config.json"))
    g_sd = torch.load(os.path.join(run_dir, f"G_{step}.pth"), weights_only=True)["model"]
    d_sd = torch.load(os.path.join(run_dir, f"D_{step}.pth"), weights_only=True)["model"]
    h_sd = torch.load(files[2], weights_only=True)["hubert"]

    def equal(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())

    g_torch = torch.load(path["G.pth"], weights_only=True)
    d_torch = torch.load(path["D.pth"], weights_only=True)
    checks = {
        "g_msgpack": equal(generator_state_dict_from_jax(load_params(path["g.msgpack"]),
                                                         cfg.model), g_sd),
        "hubert_msgpack": equal(hubert_state_dict_from_jax(load_params(path["hubert.msgpack"])),
                                h_sd),
        "g_torch": equal(g_torch["model"],
                         {k: v for k, v in g_sd.items() if k != "dec.updown_filter"}),
        "d_torch": equal(d_torch["model"], d_sd),
        "torch_schema": all(c["iteration"] == step and c["optimizer"] is None
                            and c["learning_rate"] == cfg.train.learning_rate
                            for c in (g_torch, d_torch))}
    del g_sd, d_sd, h_sd, g_torch, d_torch

    runs = {}
    for name, g, h in (("pth", os.path.join(run_dir, f"G_{step}.pth"), files[2]),
                       ("msgpack", path["g.msgpack"], path["hubert.msgpack"])):
        ops.reset_launch_counts()
        summary = run_convert([hpfile, g, h, files[3]], os.path.join(tmp, f"export_out_{name}"))
        check_outputs(summary, n_frames)
        runs[name] = {"launches": {k: v for k, v in ops.launch_counts().items() if v},
                      "waves": {os.path.basename(o): read_wav(o)[0] for o, _ in summary["outputs"]}}
    ref, ours = runs["pth"]["waves"], runs["msgpack"]["waves"]
    worst = max(float(np.abs(ours[k] - v).max() / np.abs(v).max()) for k, v in ref.items())
    out = {"step": step, "export_seconds": walls,
           "bytes": {k: os.path.getsize(v) for k, v in path.items()},
           "msgpack_or_flax_imported": imported, "checks": checks,
           "launches": {k: v["launches"] for k, v in runs.items()},
           "wave_max_abs_over_peak": worst}
    print("export " + json.dumps(out))
    require(not imported, f"phase 18 (c): the exporter imported {imported}")
    for k, ok in checks.items():
        require(ok, f"phase 18 (c): {k}")
    want = {"wave_to_mel", "attention_packed", "polar_inverse_stft"}
    require(want <= set(runs["msgpack"]["launches"])
            and runs["msgpack"]["launches"] == runs["pth"]["launches"],
            f"phase 18 (c): the .msgpack conversion launched {runs['msgpack']['launches']}")
    require(worst <= 1e-3, f"phase 18 (c): .msgpack conversion {worst} x peak off the .pth one")
    return out


def check_phase18(tmp: str, hpfile: str, files, n_frames, k4_ms: float) -> dict:
    """Phase 18: (a), (b) and (c)."""
    out = {"profile_steps": check_profile_steps(tmp, hpfile)}
    mark("phase18_a")
    out["timing_harness"] = check_timing_harness(k4_ms)
    mark("phase18_b")
    out["export"] = check_export(tmp, hpfile, files, n_frames)
    mark("phase18_c")
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
    mark("start")
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

    mark("build")
    kernels = check_kernels(dev, rng)
    bad = [k["name"] for k in kernels if not k["within_tol"]]
    attention_api = drive_attention_api(dev)
    probe = run_int8_probe()
    mark("kernels")

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
        mark("convert")
        train = check_training(tmp, rng, files, n_frames)
        mark("train")
        encoding = check_encoding(tmp, rng, files[2])
        check_encode_against_cpu(tmp, rng, files[2])
        mark("encode")
        train16 = check_training_bf16(tmp, train)
        mark("train_bf16")
        check_streaming(tmp, rng, files)
        live = check_live_sessions(dev, net_g, hubert, rng)
        check_live_bf16(live["points"])
        mark("streaming_live")
        # phase 15, on seeds of its own: the phases before it draw what they drew
        mb = check_mb_conversion(tmp, files, n_frames)
        check_mb_training(tmp, train, train16)
        check_flac(tmp, np.random.default_rng(SEED + 21), train)
        mark("mb_flac")
        # phase 16: data parallel; its draws from seeds of its own
        check_data_parallel(tmp, train["hpfile"])
        mark("data_parallel")
        # phase 17: a bit-exact resume, the sub-band loss across ranks, tensor parallelism
        phase17 = check_phase17(tmp, train["hpfile"])
        # phase 18: --profile-steps, timed / time_chained, the exporter
        k4_ms = next(k["ms"] for k in kernels if k["name"] == "wave_to_spec_halo")
        phase18 = check_phase18(tmp, train["hpfile"], files, n_frames, k4_ms)
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
    mark("tmp_cleanup")
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
    mark("cpu_reference_sessions")
    disc = check_disc_fused(dev, rng)
    disc16 = check_disc_fused_bf16(dev)
    run_disc_ab()
    mark("disc_fused")
    check_train_step_against_cpu(rng)
    # the target from past the synthetic lead-in, whose s16 samples round to
    # zero, and no masked tail: over either the sub-band loss is +inf
    # (check_mb_training says why), so its terms would compare nothing
    check_train_step_against_cpu(np.random.default_rng(SEED + 22), MB_MODEL,
                                 "train_mb_cpu_reference_check", offset=int(0.2 * SR), short=0)
    single_band = check_single_band_decoder()
    check_msgpack_reader()
    mark("train_cpu_reference_decoders")
    _, lstm_rows = check_speaker_lstm_bf16()
    check_lstm_stack_residency()
    run_bf16_step_gate()
    mark("lstm_bf16_gate")
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
    # K3 on the other two decoders' heads: launches and (rows, frames) of each path
    next(k for k in kernels if k["name"] == "polar_inverse_stft")["heads"] = {
        f"mb_{name}": {"launches": mb[name]["launches"]["polar_inverse_stft"],
                       "calls": mb[name]["k3_calls"], "check": mb[name]["k3_check"]}
        for name in ("batch", "streaming")} | {
        "single_band": {"launches": single_band["k3_launches"],
                        "calls": single_band["k3_calls"], "check": single_band["k3_check"],
                        "device_ms": single_band["k3_device_ms"],
                        "device_ms_shape": single_band["k3_conversion_shape"]}}
    # phase 17 (c): each kernel the TP step and infer run, its launches on every rank of each mesh
    for k in kernels:
        tp_launches = {mesh: v[k["name"]] for mesh, v in
                       phase17["tensor_parallel"]["launches"].items() if k["name"] in v}
        if tp_launches:
            k["tp_launches"] = tp_launches
    # phase 18: K4 and the LSTM stacks in the traced run, K1-K3 in the .msgpack conversion
    phase18_launches = phase18["profile_steps"]["launches"] | phase18["export"]["launches"][
        "msgpack"]
    for k in kernels:
        if k["name"] in phase18_launches:
            k["phase18_launches"] = phase18_launches[k["name"]]
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
                      "layers_equal_one_layer_kernel", "accuracy", "heads", "tp_launches",
                      "phase18_launches"):
            if extra in k:
                detail[extra] = k[extra]
        print("kernel_check " + json.dumps(detail))
    mark("report")
    print("phase_seconds " + json.dumps(PHASE_SECONDS))
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
        | ({"tp_launches": k["tp_launches"]} if "tp_launches" in k else {})
        | ({"phase18_launches": k["phase18_launches"]} if "phase18_launches" in k else {})
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
