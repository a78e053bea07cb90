"""Kernel K1: wave -> log-mel (``csrc/fused_mel.cu``) and its dispatch.

Replaces the TPU kernel ``quickvc_tpu/ops/fused_mel.py:wave_to_mel_pallas``.
A CPU tensor takes the plain version, :func:`quickvc_tpu_torch.dsp.stft.wave_to_mel`;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from quickvc_tpu_torch.dsp.mel import mel_filterbank
from quickvc_tpu_torch.dsp.stft import wave_to_mel as wave_to_mel_plain
from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("wave_to_mel")


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


def wave_to_mel_kernel(y: torch.Tensor, sr: int, n_fft: int, hop: int, win: int,
                       n_mels: int, fmin: float = 0.0,
                       fmax: float | None = None) -> torch.Tensor:
    """Launch K1: (B, T) float32 CUDA -> (B, T//hop, n_mels)."""
    require_cuda_f32("wave_to_mel", y)
    if y.dim() != 2 or not y.is_contiguous():
        raise ValueError(f"wave_to_mel: need a contiguous (B, T) wave, got "
                         f"{tuple(y.shape)} strides {y.stride()}")
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
    if y.device.type == "cpu":
        fb = torch.as_tensor(_mel_tables(sr, n_fft, n_mels, fmin, fmax)[0])
        return wave_to_mel_plain(y, fb, n_fft, hop, win)
    return wave_to_mel_kernel(y, sr, n_fft, hop, win, n_mels, fmin, fmax)
