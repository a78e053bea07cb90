"""Kernel K3: polar decode + inverse STFT head (``csrc/fused_istft.cu``) and its dispatch.

Replaces the TPU kernel ``quickvc_tpu/ops/fused_istft.py:polar_inverse_stft_pallas``.
A CPU tensor takes the plain version,
:func:`quickvc_tpu_torch.dsp.istft.polar_inverse_stft`; a CUDA tensor
launches the kernel or raises. The kernel takes the (n_fft, hop) pairs the
TPU kernel asserts, with n_fft up to :data:`MAX_N_FFT`: :func:`istft_route`
says which body runs, the one compiled for the decoder's 16 / 4 or the one
that reads :func:`istft_table`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as polar_inverse_stft_plain
from quickvc_tpu_torch.dsp.stft import hann_window
from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library, refuse_grad,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("polar_inverse_stft")
# the (n_fft, hop) with a body of its own (configs/quickvc.json decoder), 4.4x
# faster there than the table-driven body (csrc/fused_istft.cu)
COMPILED = (16, 4)
MAX_N_FFT = 2048
MAX_FRAMES_PER_HOP = 128   # n_fft / hop, the TPU kernel's bound (its halo of 128 lanes)


def istft_route(n_fft: int, hop: int) -> str:
    """K3's body for (n_fft, hop): ``"compiled"`` for :data:`COMPILED`,
    ``"table"`` for any other pair with hop | n_fft, n_fft / hop even and at
    most 128 (the asserts of ``quickvc_tpu/ops/fused_istft.py``) and n_fft up
    to :data:`MAX_N_FFT`; ``ValueError`` for the rest."""
    r = n_fft // hop if hop > 0 else 0
    if hop <= 0 or n_fft % hop or r % 2 or not 0 < r <= MAX_FRAMES_PER_HOP \
            or n_fft > MAX_N_FFT:
        raise ValueError(f"polar_inverse_stft: the kernel takes hop | n_fft with n_fft/hop "
                         f"even and at most {MAX_FRAMES_PER_HOP}, n_fft <= {MAX_N_FFT}; "
                         f"got n_fft={n_fft} hop={hop}")
    return "compiled" if (n_fft, hop) == COMPILED else "table"


@functools.lru_cache(maxsize=None)
def istft_table(n_fft: int) -> np.ndarray:
    """What the run-time body reads besides the spectra, float32, each value
    rounded once from float64: cos and sin(2 pi j / n_fft), j < n_fft; the
    periodic Hann window over n_fft; its square."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    w = hann_window(n_fft, np.float64)
    return np.concatenate([np.cos(ang), np.sin(ang), w / n_fft, w * w]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_table(device: torch.device, n_fft: int) -> torch.Tensor:
    return torch.as_tensor(istft_table(n_fft), device=device)


def polar_inverse_stft_kernel(log_mag: torch.Tensor, phase: torch.Tensor,
                              n_fft: int, hop: int) -> torch.Tensor:
    """Launch K3: (rows, F, n_fft//2+1) x2 float32 CUDA, any strides ->
    (rows, hop*(F-1)); (n_fft, hop) as :func:`istft_route` takes them."""
    require_cuda_f32("polar_inverse_stft", log_mag, phase)
    route = istft_route(n_fft, hop)
    n_freq = n_fft // 2 + 1
    if (log_mag.dim() != 3 or log_mag.shape != phase.shape
            or log_mag.shape[2] != n_freq or log_mag.shape[1] < 2):
        raise ValueError(f"polar_inverse_stft: need two (rows, F>=2, {n_freq}) spectra, "
                         f"got {tuple(log_mag.shape)} and {tuple(phase.shape)}")
    rows, f, _ = log_mag.shape
    out = torch.empty((rows, hop * (f - 1)), device=log_mag.device, dtype=torch.float32)
    table = None if route == "compiled" else _device_table(log_mag.device, n_fft).data_ptr()
    check(library().qvc_polar_istft(
        log_mag.data_ptr(), phase.data_ptr(), *log_mag.stride(), *phase.stride(),
        out.data_ptr(), rows, f, n_fft, hop, table, stream_ptr(log_mag)),
        f"polar_inverse_stft kernel ({route})")
    STATS.count()
    return out


def polar_inverse_stft(log_mag: torch.Tensor, phase: torch.Tensor,
                       n_fft: int, hop: int) -> torch.Tensor:
    """(rows, F, n_fft//2+1) x2 -> (rows, hop*(F-1)): plain on CPU, K3 on CUDA.

    K3 has no backward, so inputs that require grad are refused on both
    devices; training differentiates through the plain version directly.
    """
    refuse_grad("polar_inverse_stft", log_mag, phase)
    if log_mag.device.type == "cpu":
        return polar_inverse_stft_plain(log_mag, phase, n_fft, hop)
    return polar_inverse_stft_kernel(log_mag, phase, n_fft, hop)
