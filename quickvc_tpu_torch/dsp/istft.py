"""Polar inverse STFT of the decoder head, plain PyTorch (the oracle of kernel K3).

Same contract as ``quickvc_tpu/dsp/istft.py``: ``torch.istft`` with
``center=True``, periodic Hann, onesided; the spectrum is decoded from the
decoder's polar output ``exp(log_mag) * exp(i * pi * sin(phase_raw))``
(reference ``models.py:399-401``). The irDFT is two small matmuls against
windowed inverse-DFT matrices and the overlap-add is ``n_fft/hop`` shifted
adds, exactly as the JAX version does it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from quickvc_tpu_torch.dsp.stft import hann_window


@functools.lru_cache(maxsize=None)
def _inverse_dft_matrices(n_fft: int):
    """Windowed inverse real-DFT matrices (freq, n_fft) for re and im parts.

    frame[n] = (1/N) * sum_k c_k * (re_k cos(2 pi k n / N) - im_k sin(...)),
    c_k = 1 for k in {0, N/2} and 2 otherwise, times the synthesis window.
    """
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((n_freq, 1), 2.0)
    c[0, 0] = 1.0
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0
    w = hann_window(n_fft, np.float64)[None, :]
    basis_re = (c * np.cos(ang) / n_fft) * w
    basis_im = (-c * np.sin(ang) / n_fft) * w
    return basis_re.astype(np.float32), basis_im.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ola_envelope(num_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """Inverse of the overlap-added squared window (length hop*(F-1)+n_fft)."""
    w2 = hann_window(n_fft, np.float64) ** 2
    env = np.zeros(hop * (num_frames - 1) + n_fft)
    for f in range(num_frames):
        env[f * hop : f * hop + n_fft] += w2
    half = n_fft // 2
    if env[half:-half].min() <= 1e-11:
        raise ValueError("OLA envelope has near-zeros in the output region")
    # the trimmed edges (hann[0] == 0) may be zero: guard them for the division
    env = np.where(env < 1e-11, 1.0, env)
    return (1.0 / env).astype(np.float32)


def _overlap_add(frames: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., Frame, n_fft) -> (..., hop*(Frame-1) + n_fft) via R shifted adds."""
    r = n_fft // hop
    num_frames = frames.shape[-2]
    chunks = frames.reshape(*frames.shape[:-1], r, hop)      # (..., F, R, hop)
    total_p = num_frames + r - 1
    out = 0
    for j in range(r):
        # chunk j of frame f lands on output chunk f + j
        out = out + F.pad(chunks[..., j, :], (0, 0, j, total_p - num_frames - j))
    return out.reshape(*out.shape[:-2], total_p * hop)


def polar_inverse_stft(log_mag: torch.Tensor, phase_raw: torch.Tensor,
                       n_fft: int, hop: int) -> torch.Tensor:
    """(..., Frame, Freq) x2 -> waveform (..., hop*(Frame-1)), float32."""
    if n_fft % hop:
        raise ValueError(f"hop {hop} must divide n_fft {n_fft}")
    mag = torch.exp(log_mag.float())
    phase = torch.pi * torch.sin(phase_raw.float())
    basis_re, basis_im = (torch.as_tensor(b, device=mag.device)
                          for b in _inverse_dft_matrices(n_fft))
    frames = (mag * torch.cos(phase)) @ basis_re + (mag * torch.sin(phase)) @ basis_im
    y = _overlap_add(frames, n_fft, hop)
    env = torch.as_tensor(_ola_envelope(frames.shape[-2], n_fft, hop), device=y.device)
    half = n_fft // 2
    return (y * env)[..., half:-half]
