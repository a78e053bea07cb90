"""Kernels K1 (wave -> log-mel) and K4 (halo'd wave -> linear spectrogram),
both in ``csrc/fused_mel.cu``, and their dispatch.

K1 replaces the TPU kernel ``quickvc_tpu/ops/fused_mel.py:wave_to_mel_pallas``,
K4 replaces ``quickvc_tpu/ops/fused_mel.py:wave_to_spec_halo_pallas``.
K4 is a real FFT: :func:`fft_plan` gives the radices of its half-length
complex FFT and :func:`spec_fft_table` the twiddles and window it reads;
both are built here, so the CPU tests check what the kernel is handed.
A CPU tensor takes the plain version (:func:`quickvc_tpu_torch.dsp.stft.wave_to_mel`,
:func:`quickvc_tpu_torch.dsp.stft.wave_to_spec_halo`); a CUDA tensor
launches the kernel or raises. Neither kernel has a backward, so both
dispatchers refuse inputs that require grad.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from quickvc_tpu_torch.dsp.mel import mel_filterbank
from quickvc_tpu_torch.dsp.stft import padded_window
from quickvc_tpu_torch.dsp.stft import wave_to_mel as wave_to_mel_plain
from quickvc_tpu_torch.dsp.stft import wave_to_spec_halo as wave_to_spec_halo_plain
from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library, refuse_grad,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("wave_to_mel")
SPEC_STATS = KernelStats("wave_to_spec_halo")


@functools.lru_cache(maxsize=None)
def _mel_tables(sr: int, n_fft: int, n_mels: int, fmin: float,
                fmax: float | None) -> tuple[np.ndarray, np.ndarray]:
    """Filterbank (n_mels, n_freq) and each filter's nonzero band [lo, hi)."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    rng = np.zeros((n_mels, 2), np.int32)
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        if nz.size:
            rng[m] = nz[0], nz[-1] + 1
    return fb, rng


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device, sr, n_fft, n_mels, fmin, fmax):
    fb, rng = _mel_tables(sr, n_fft, n_mels, fmin, fmax)
    return torch.as_tensor(fb, device=device), torch.as_tensor(rng, device=device)


def _require_wave(name: str, y: torch.Tensor) -> None:
    require_cuda_f32(name, y)
    if y.dim() != 2 or not y.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (B, T) wave, got "
                         f"{tuple(y.shape)} strides {y.stride()}")


def wave_to_mel_kernel(y: torch.Tensor, sr: int, n_fft: int, hop: int, win: int,
                       n_mels: int, fmin: float = 0.0,
                       fmax: float | None = None) -> torch.Tensor:
    """Launch K1: (B, T) float32 CUDA -> (B, T//hop, n_mels)."""
    _require_wave("wave_to_mel", y)
    b, t = y.shape
    if n_fft % hop or win > n_fft or t <= (n_fft - hop) // 2 or t < hop:
        raise ValueError(f"wave_to_mel: unsupported n_fft={n_fft} hop={hop} "
                         f"win={win} for T={t}")
    n_frames = t // hop
    fb, rng = _device_tables(y.device, sr, n_fft, n_mels, fmin, fmax)
    out = torch.empty((b, n_frames, n_mels), device=y.device, dtype=torch.float32)
    check(library().qvc_wave_to_mel(
        y.data_ptr(), fb.data_ptr(), rng.data_ptr(), out.data_ptr(), b, t,
        n_frames, n_fft, hop, win, n_fft // 2 + 1, n_mels, stream_ptr(y)),
        "wave_to_mel kernel")
    STATS.launches += 1
    return out


def wave_to_mel(y: torch.Tensor, sr: int, n_fft: int, hop: int, win: int,
                n_mels: int, fmin: float = 0.0,
                fmax: float | None = None) -> torch.Tensor:
    """(B, T) -> (B, T//hop, n_mels) log-mel: plain on CPU, K1 on CUDA."""
    refuse_grad("wave_to_mel", y)
    if y.device.type == "cpu":
        fb = torch.as_tensor(_mel_tables(sr, n_fft, n_mels, fmin, fmax)[0])
        return wave_to_mel_plain(y, fb, n_fft, hop, win)
    return wave_to_mel_kernel(y, sr, n_fft, hop, win, n_mels, fmin, fmax)


FFT_SIZES = (256, 320, 512, 640, 1024, 1280, 2048)   # n_fft = 2^a * 5^b, b <= 1


def fft_plan(n_fft: int) -> tuple[int, ...]:
    """Radices of K4's complex FFT of n_fft/2 points, one Stockham pass each,
    in pass order: a 5 first where n_fft has one, then the power of two
    2^e in ceil(e/4) passes of 16, 8, 4 or 2, the larger first (radix 8 and
    16 are two radix-4/2 stages in registers).

    K4 packs even and odd samples of a real frame as the real and imaginary
    parts of n_fft/2 complex points. It takes the n_fft of :data:`FFT_SIZES`;
    any other raises ``ValueError``. The kernel is compiled with the same
    rule (``csrc/fused_mel.cu:make_plan``) and refuses another plan.
    """
    if n_fft not in FFT_SIZES:
        raise ValueError(f"wave_to_spec_halo: the kernel takes n_fft in {FFT_SIZES} "
                         f"(2^a * 5^b, b <= 1), got {n_fft}")
    m, radices = n_fft // 2, []
    if m % 5 == 0:
        radices.append(5)
        m //= 5
    e = m.bit_length() - 1
    passes = -(-e // 4)
    radices += [1 << ((e + passes - 1 - i) // passes) for i in range(passes)]
    return tuple(radices)


@functools.lru_cache(maxsize=None)
def spec_fft_table(n_fft: int, win: int) -> np.ndarray:
    """Everything K4 reads besides the wave, float32, each value rounded once
    from float64, in this order:

    - per stage of :func:`fft_plan` (radix R after stages whose radices
      multiply to Ns): (Ns, R-1) complex twiddles exp(-2 pi i k r / (Ns R)),
      k < Ns, r = 1..R-1, as (re, im) pairs;
    - the recombination twiddles exp(-2 pi i k / n_fft), k = 0..n_fft/2;
    - the periodic Hann(win) window centred in n_fft samples.
    """
    parts, ns = [], 1
    for r in fft_plan(n_fft):
        ang = -2.0 * np.pi * np.arange(ns)[:, None] * np.arange(1, r)[None, :] / (ns * r)
        parts.append(np.stack([np.cos(ang), np.sin(ang)], -1).ravel())
        ns *= r
    ang = -2.0 * np.pi * np.arange(n_fft // 2 + 1) / n_fft
    parts.append(np.stack([np.cos(ang), np.sin(ang)], -1).ravel())
    parts.append(padded_window(n_fft, win))
    return np.concatenate(parts).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_spec_table(device: torch.device, n_fft: int, win: int) -> torch.Tensor:
    return torch.as_tensor(spec_fft_table(n_fft, win), device=device)


def wave_to_spec_halo_kernel(y: torch.Tensor, n_fft: int, hop: int,
                             win: int) -> torch.Tensor:
    """Launch K4: (B, T + n_fft - hop) float32 CUDA -> (B, T//hop, n_fft//2+1).
    n_fft in :data:`FFT_SIZES`, hop <= n_fft, win <= n_fft."""
    _require_wave("wave_to_spec_halo", y)
    b, t = y.shape
    radices = fft_plan(n_fft)
    if win > n_fft or not 0 < hop <= n_fft or t < n_fft:
        raise ValueError(f"wave_to_spec_halo: unsupported n_fft={n_fft} "
                         f"hop={hop} win={win} for T={t}")
    n_frames = 1 + (t - n_fft) // hop
    n_freq = n_fft // 2 + 1
    plan = sum(r << (8 * i) for i, r in enumerate(radices))
    table = _device_spec_table(y.device, n_fft, win)
    out = torch.empty((b, n_frames, n_freq), device=y.device, dtype=torch.float32)
    check(library().qvc_wave_to_spec_halo(
        y.data_ptr(), table.data_ptr(), out.data_ptr(), b, t, n_frames, n_fft, hop,
        plan, stream_ptr(y)), "wave_to_spec_halo kernel")
    SPEC_STATS.launches += 1
    return out


def wave_to_spec_halo(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """(B, T + n_fft - hop) halo'd wave -> (B, T//hop, n_fft//2+1) linear
    spectrogram: plain on CPU, K4 on CUDA."""
    refuse_grad("wave_to_spec_halo", y)
    if y.device.type == "cpu":
        return wave_to_spec_halo_plain(y, n_fft, hop, win)
    return wave_to_spec_halo_kernel(y, n_fft, hop, win)
