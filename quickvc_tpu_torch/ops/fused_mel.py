"""Kernels K1 (wave -> log-mel) and K4 (halo'd wave -> linear spectrogram),
both in ``csrc/fused_mel.cu``, and their dispatch.

K1 replaces the TPU kernel ``quickvc_tpu/ops/fused_mel.py:wave_to_mel_pallas``,
K4 replaces ``quickvc_tpu/ops/fused_mel.py:wave_to_spec_halo_pallas``.
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


def wave_to_spec_halo_kernel(y: torch.Tensor, n_fft: int, hop: int,
                             win: int) -> torch.Tensor:
    """Launch K4: (B, T + n_fft - hop) float32 CUDA -> (B, T//hop, n_fft//2+1)."""
    _require_wave("wave_to_spec_halo", y)
    b, t = y.shape
    if win > n_fft or hop > n_fft or t < n_fft:
        raise ValueError(f"wave_to_spec_halo: unsupported n_fft={n_fft} "
                         f"hop={hop} win={win} for T={t}")
    n_frames = 1 + (t - n_fft) // hop
    n_freq = n_fft // 2 + 1
    out = torch.empty((b, n_frames, n_freq), device=y.device, dtype=torch.float32)
    check(library().qvc_wave_to_spec_halo(
        y.data_ptr(), out.data_ptr(), b, t, n_frames, n_fft, hop, win, n_freq,
        stream_ptr(y)), "wave_to_spec_halo kernel")
    SPEC_STATS.launches += 1
    return out


def wave_to_spec_halo(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """(B, T + n_fft - hop) halo'd wave -> (B, T//hop, n_fft//2+1) linear
    spectrogram: plain on CPU, K4 on CUDA."""
    refuse_grad("wave_to_spec_halo", y)
    if y.device.type == "cpu":
        return wave_to_spec_halo_plain(y, n_fft, hop, win)
    return wave_to_spec_halo_kernel(y, n_fft, hop, win)
