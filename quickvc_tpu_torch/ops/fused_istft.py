"""Kernel K3: polar decode + inverse STFT head (``csrc/fused_istft.cu``) and its dispatch.

Replaces the TPU kernel ``quickvc_tpu/ops/fused_istft.py:polar_inverse_stft_pallas``.
A CPU tensor takes the plain version,
:func:`quickvc_tpu_torch.dsp.istft.polar_inverse_stft`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as polar_inverse_stft_plain
from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library, refuse_grad,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("polar_inverse_stft")
N_FFT, HOP = 16, 4  # compiled into the kernel (configs/quickvc.json decoder)


def polar_inverse_stft_kernel(log_mag: torch.Tensor, phase: torch.Tensor,
                              n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """Launch K3: (rows, F, 9) x2 float32 CUDA, any strides -> (rows, 4*(F-1))."""
    require_cuda_f32("polar_inverse_stft", log_mag, phase)
    if (n_fft, hop) != (N_FFT, HOP):
        raise ValueError(f"polar_inverse_stft kernel is built for n_fft={N_FFT} "
                         f"hop={HOP}, got {n_fft}/{hop}")
    if (log_mag.dim() != 3 or log_mag.shape != phase.shape
            or log_mag.shape[2] != N_FFT // 2 + 1 or log_mag.shape[1] < 2):
        raise ValueError(f"polar_inverse_stft: need two (rows, F>=2, "
                         f"{N_FFT // 2 + 1}) spectra, got {tuple(log_mag.shape)} "
                         f"and {tuple(phase.shape)}")
    rows, f, _ = log_mag.shape
    out = torch.empty((rows, HOP * (f - 1)), device=log_mag.device,
                      dtype=torch.float32)
    check(library().qvc_polar_istft(
        log_mag.data_ptr(), phase.data_ptr(), *log_mag.stride(), *phase.stride(),
        out.data_ptr(), rows, f, stream_ptr(log_mag)), "polar_inverse_stft kernel")
    STATS.launches += 1
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
