#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``quickvc_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the hand-written kernels from ``quickvc_tpu_torch/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and times kernel, plain version and one
   PyTorch library call for the same function (CUDA events, after warm-up).
3. Drives the main path, the conversion CLI ``quickvc_tpu_torch.convert``
   with ``--device cuda --batch 8``, at the full width of
   ``configs/quickvc.json`` plus the full HuBERT-soft, with seeded random
   weights, on seeded synthetic wavs; checks the outputs and that every
   kernel was launched, with the launch counters zeroed just before;
   repeats the conversion for the throughput over all repeats; then
   converts once more under torch.profiler for the device time by kernel
   and the device's busy share of the conversion loop in that trace.
4. Checks the whole path on the card against the CPU plain path on a
   small input (noise 0).

Prints one JSON line per kernel check, the card's name and power limit,
the status of every TPU kernel of the JAX package, a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero. Without a CUDA card, or outside a checkout of the repo, it exits
non-zero and prints no result. Imports nothing of JAX or ``quickvc_tpu``.
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
# H100 SXM peaks (NVIDIA data sheet): float32 FMA rate and HBM rate
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12

TPU_KERNELS = [
    ("K1", "quickvc_tpu/ops/fused_mel.py:227", "wave_to_mel_pallas",
     "ported: quickvc_tpu_torch/csrc/fused_mel.cu"),
    ("K2", "quickvc_tpu/ops/fused_attention.py:113", "fused_attention_packed",
     "ported: quickvc_tpu_torch/csrc/fused_attention.cu"),
    ("K3", "quickvc_tpu/ops/fused_istft.py:159", "polar_inverse_stft_pallas",
     "ported: quickvc_tpu_torch/csrc/fused_istft.cu"),
    ("K4", "quickvc_tpu/ops/fused_mel.py:177", "wave_to_spec_halo_pallas", "to port: training slice"),
    ("K5", "quickvc_tpu/ops/fused_disc_conv.py:117", "conv5_lrelu forward", "to port: training slice"),
    ("K6", "quickvc_tpu/ops/fused_disc_conv.py:156", "conv5_lrelu dW", "to port: training slice"),
    ("K7", "quickvc_tpu/ops/fused_extractor.py:187", "fused_extractor_front", "to port"),
    ("K8", "quickvc_tpu/ops/fused_transformer.py:155", "fused_transformer_layer", "to port"),
    ("K9", "quickvc_tpu/ops/fused_attention.py:194", "fused_attention_packed_aligned",
     "to port: layout wrapper over K2"),
    ("K10", "quickvc_tpu/ops/fused_attention.py:231", "fused_attention",
     "to port: layout wrapper over K2"),
    ("K11", "scripts/int8_matmul_probe.py:85", "pallas_mm", "to port: int8 rate probe"),
]


class CheckFailed(Exception):
    """A check of the smoke run failed; the run exits non-zero."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(ours: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> dict:
    diff = (ours - ref).abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / ref.abs().clamp(min=1e-12)).max()),
            "within_tol": bool((diff <= atol + rtol * ref.abs()).all()),
            "atol": atol, "rtol": rtol}


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

    results = []

    # K1 at the longest target's bucket: (1, 9 s) -> (1, 450, 80)
    t_len = int(np.ceil(max(TARGET_SECONDS))) * SR
    y = torch.from_numpy(synth_voice(t_len / SR, SR, rng)[None]).to(dev)
    fb = torch.as_tensor(mel_filterbank(SR, 1280, 80), device=dev)
    win = torch.as_tensor(hann_window(1280), device=dev)

    def k1():
        return fused_mel.wave_to_mel_kernel(y, SR, 1280, 320, 1280, 80)

    def k1_plain():
        return mel_plain(y, fb, 1280, 320, 1280)

    def k1_library():
        yp = F.pad(y[:, None], (480, 480), mode="reflect")[:, 0]
        z = torch.stft(yp, 1280, 320, 1280, win, center=False, return_complex=True)
        return torch.log(torch.clamp(fb @ torch.sqrt(z.abs() ** 2 + 1e-6), min=1e-5))

    # The least work a log-mel needs: per frame a real FFT (2.5 N log2 N flops),
    # the window, |z|^2 over 641 bins and the mel product over the filters'
    # nonzero bands; bytes are the wave, the nonzero filter taps and the output.
    # The kernel's own dense DFT (2·1280·1282 flops per frame) is printed apart.
    frames = t_len // 320
    nnz = int((fb != 0).sum())
    flops = (2.5 * 1280 * np.log2(1280) + 1280 + 3 * 641 + 2 * nnz) * frames
    nbytes = 4 * (t_len + nnz + frames * 80)
    results.append(dict(
        name="wave_to_mel", tpu_id="K1", source="quickvc_tpu_torch/csrc/fused_mel.cu",
        replaces="quickvc_tpu/ops/fused_mel.py:227",
        shape=[list(y.shape), [1, frames, 80]], **compare(k1(), k1_plain(), 2e-3, 2e-3),
        ms=cuda_ms(k1), plain_ms=cuda_ms(k1_plain), library_ms=cuda_ms(k1_library),
        bound_ops_ms=flops / F32_FLOPS * 1e3, bound_bytes_ms=nbytes / HBM_BYTES * 1e3,
        dense_dft_ops_ms=(2 * 1280 * 1282 + 2 * nnz) * frames / F32_FLOPS * 1e3))

    # K2 at one HuBERT layer of the 5-s source bucket: (8, 250, 768), views of qkv
    b, t_u, d = BATCH, 5 * SR // 320, 768
    qkv = torch.randn(b, t_u, 3 * d, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    q, k, v = qkv.chunk(3, dim=-1)
    qh, kh, vh = (z.reshape(b, t_u, 12, 64).transpose(1, 2).contiguous() for z in (q, k, v))

    def k2():
        return fused_attention.attention_packed_kernel(q, k, v, 12, 0.125)

    def k2_plain():
        return fused_attention.attention_packed_reference(q, k, v, 12, 0.125)

    def k2_library():
        return F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)

    results.append(dict(
        name="attention_packed", tpu_id="K2", source="quickvc_tpu_torch/csrc/fused_attention.cu",
        replaces="quickvc_tpu/ops/fused_attention.py:113",
        shape=[[b, t_u, d]] * 3, **compare(k2(), k2_plain(), 1e-4, 1e-3),
        ms=cuda_ms(k2), plain_ms=cuda_ms(k2_plain), library_ms=cuda_ms(k2_library),
        bound_ops_ms=4 * b * t_u * t_u * d / F32_FLOPS * 1e3,
        bound_bytes_ms=4 * 4 * b * t_u * d / HBM_BYTES * 1e3))

    # K3 at the decoder head of the same batch: 4 bands x 8 rows, 20*250+1 frames,
    # read as strided views of the subband conv output like the decoder does
    rows, f = 4 * BATCH, 20 * t_u + 1
    conv_out = 0.5 * torch.randn(rows, 18, f, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    spec = conv_out.transpose(1, 2)
    lm, ph = spec[..., :9], spec[..., 9:]

    def k3():
        return fused_istft.polar_inverse_stft_kernel(lm, ph)

    def k3_plain():
        return istft_plain(lm, ph, 16, 4)

    hann16 = torch.hann_window(16, device=dev)

    def k3_library():
        z = torch.polar(torch.exp(lm), torch.pi * torch.sin(ph)).transpose(1, 2)
        return torch.istft(z, 16, 4, 16, hann16, center=True)

    results.append(dict(
        name="polar_inverse_stft", tpu_id="K3", source="quickvc_tpu_torch/csrc/fused_istft.cu",
        replaces="quickvc_tpu/ops/fused_istft.py:159",
        shape=[[rows, f, 9]] * 2, **compare(k3(), k3_plain(), 1e-4, 1e-3),
        ms=cuda_ms(k3), plain_ms=cuda_ms(k3_plain), library_ms=cuda_ms(k3_library),
        bound_ops_ms=rows * 4 * (f - 1) * 2 * 72 / F32_FLOPS * 1e3,
        bound_bytes_ms=4 * (2 * rows * f * 9 + rows * 4 * (f - 1)) / HBM_BYTES * 1e3))

    for r in results:
        r["bound_ms"] = max(r["bound_ops_ms"], r["bound_bytes_ms"])
        r["bound_by"] = "operations" if r["bound_ops_ms"] >= r["bound_bytes_ms"] else "bytes"
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


def profile_convert(files, outdir: str) -> dict:
    """One more conversion under torch.profiler: device time by kernel, and
    the device's busy share of the CLI's conversion loop in the same trace
    (the union of kernel intervals inside the loop's span, over the span;
    the profiler's own host overhead lengthens the span)."""
    from torch.profiler import ProfilerActivity, profile

    from quickvc_tpu_torch.convert import LOOP_SPAN

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_convert(files, outdir)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0
                  and e.key != LOOP_SPAN]
    kernels = [e for e in dev_events if not e.key.startswith(("Memcpy", "Memset"))]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    ours = ("wave_to_mel_kernel", "attention_kernel", "polar_istft_kernel")

    events = prof.events()
    loops = [e for e in events if e.name == LOOP_SPAN and e.device_type != cuda]
    require(len(loops) == 1, f"one {LOOP_SPAN} span in the trace, found {len(loops)}")
    lo, hi = loops[0].time_range.start, loops[0].time_range.end
    kernel_iv = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and e.name != LOOP_SPAN
                 and not e.name.startswith(("Memcpy", "Memset"))]
    copy_iv = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == cuda and e.name.startswith("Memcpy")]
    busy_us = union_us(kernel_iv, lo, hi)
    require(hi > lo and busy_us > 0, "device kernels ran inside the conversion loop's span")
    return {
        "device_kernel_ms": total_ms,
        "memcpy_ms": sum(e.self_device_time_total for e in dev_events
                         if e.key.startswith("Memcpy")) / 1e3,
        "loop_span_ms": (hi - lo) / 1e3,
        "kernel_busy_ms_in_loop": busy_us / 1e3,
        "memcpy_busy_ms_in_loop": union_us(copy_iv, lo, hi) / 1e3,
        "kernel_busy_share_of_loop": busy_us / (hi - lo),
        "port_kernels_ms": {o: sum(e.self_device_time_total for e in kernels if o in e.key) / 1e3
                            for o in ours},
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    t0 = time.time()
    lib = _cuda.build()
    _cuda.library()
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print("build " + json.dumps({"seconds": round(time.time() - t0, 2), "library": lib.name,
                                 "ptxas": ptxas}))

    kernels = check_kernels(dev, rng)
    bad = [k["name"] for k in kernels if not k["within_tol"]]

    with tempfile.TemporaryDirectory(prefix="qvc_smoke_") as tmp:
        cfg, net_g, hubert, files, n_frames = make_inputs(
            tmp, rng, os.path.join(ROOT, "configs", "quickvc.json"))
        run_convert(files, os.path.join(tmp, "warmup"))  # cuDNN set-up, allocator
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        summary = run_convert(files, os.path.join(tmp, "out"))
        launches = ops.launch_counts()
        runs = [summary] + [run_convert(files, os.path.join(tmp, f"out{i}"))
                            for i in range(1, REPEATS)]
        for run in runs:
            check_outputs(run, n_frames)
        print("profile " + json.dumps(profile_convert(files, os.path.join(tmp, "prof"))))
    buckets = Counter(int(np.ceil(s)) for s in SOURCE_SECONDS)   # 1-s length buckets
    n_batches = sum(-(-n // BATCH) for n in buckets.values())
    expected = {"wave_to_mel": len(TARGET_SECONDS), "attention_packed": 12 * n_batches,
                "polar_inverse_stft": n_batches}
    audio = sum(r["audio_seconds"] for r in runs)
    wall = sum(r["wall_seconds"] for r in runs)
    throughput = {"pairs": summary["pairs"], "batches": n_batches, "repeats": REPEATS,
                  "audio_seconds": audio, "wall_seconds": wall,
                  "audio_s_per_wall_s": audio / wall,
                  "per_run_audio_s_per_wall_s": [r["audio_seconds"] / r["wall_seconds"]
                                                 for r in runs],
                  "launches": launches, "expected_launches": expected}
    print("convert " + json.dumps(throughput))
    reference = check_against_cpu(cfg, net_g, hubert, rng)

    for k in kernels:
        k["launches"] = launches[k["name"]]
        detail = {x: k[x] for x in ("name", "tpu_id", "shape", "max_abs_err", "max_rel_err",
                                    "atol", "rtol", "within_tol", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")}
        if "dense_dft_ops_ms" in k:
            detail["dense_dft_ops_ms"] = k["dense_dft_ops_ms"]
        detail["launches_per_batch"] = k["launches"] / n_batches
        print("kernel_check " + json.dumps(detail))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"tpu_kernels": [{"id": i, "pallas_call": at, "function": fn,
                                       "status": st} for i, at, fn, st in TPU_KERNELS]}))
    require(not bad, f"kernels outside tolerance: {bad}")
    require(launches == expected, f"launch counts {launches} != expected {expected}")
    require(reference["wave_shape"][-1] == SR, "CPU-reference wave length")
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"]} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
