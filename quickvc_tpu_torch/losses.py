"""GAN, feature-matching, KL and multi-resolution STFT losses (port of
``quickvc_tpu/losses.py``, reference ``losses.py``).

Per-discriminator terms come back stacked as tensors, not Python floats, so
computing them needs no host sync.
"""

from __future__ import annotations

from typing import Sequence

import torch

from quickvc_tpu_torch.dsp.stft import magnitude_stft


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching against detached real features, x2."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    """LSGAN D loss: (1 - D(y))^2 + D(y_hat)^2; returns (sum, real terms, fake terms)."""
    r_losses = torch.stack([torch.mean((1.0 - dr) ** 2) for dr in disc_real])
    g_losses = torch.stack([torch.mean(dg ** 2) for dg in disc_gen])
    return torch.sum(r_losses + g_losses), r_losses, g_losses


def generator_loss(disc_gen):
    """LSGAN G loss: (1 - D(y_hat))^2; returns (sum, per-discriminator terms)."""
    gen_losses = torch.stack([torch.mean((1.0 - dg) ** 2) for dg in disc_gen])
    return torch.sum(gen_losses), gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p) -> torch.Tensor:
    """VITS KL between the flow-mapped posterior and the unit prior."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.mean(kl)


def _stft_losses(x, y, n_fft: int, hop: int, win: int):
    """(spectral convergence, log magnitude) at one resolution, in float64."""
    x_mag = magnitude_stft(x.double(), n_fft, hop, win)
    y_mag = magnitude_stft(y.double(), n_fft, hop, win)
    sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor, fft_sizes: Sequence[int],
                               hop_sizes: Sequence[int], win_lengths: Sequence[int]):
    """(spectral convergence, log magnitude), each averaged over the resolutions;
    ``x`` the generated waves, ``y`` the targets, (..., T) each.

    The magnitudes, their logs and the sums run in float64 and come back in
    float32 (float64 for float64 inputs). The log-magnitude's gradient is
    1/|z|, and generated bands have bins near the rounding of a float32 FFT,
    where a float32 gradient is mostly rounding, more so through cuFFT than
    the CPU's FFT (``chip_smoke.py``'s ``train_mb_cpu_reference_check``
    line prints both). The JAX package computes it in float32
    (``quickvc_tpu/losses.py:45-67``); its result lies within that rounding
    of this one.
    """
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    sc_total, mag_total = 0.0, 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = _stft_losses(x, y, n_fft, hop, win)
        sc_total, mag_total = sc_total + sc, mag_total + mag
    n = len(fft_sizes)
    return (sc_total / n).to(dtype), (mag_total / n).to(dtype)


def subband_stft_loss(y_mb: torch.Tensor, y_hat_mb: torch.Tensor, fft_sizes: Sequence[int],
                      hop_sizes: Sequence[int], win_lengths: Sequence[int]) -> torch.Tensor:
    """Sub-band MR-STFT loss, sc + log-mag: the target bands ``y_mb`` and the
    generated ones ``y_hat_mb``, channels-first (B, Band, T) each, the bands
    folded into the batch and the generated ones cropped to the target's
    length (``quickvc_tpu/losses.py:70-83`` takes them channels-last)."""
    t = y_mb.shape[-1]
    y_flat = y_mb.reshape(-1, t)
    y_hat = y_hat_mb.reshape(-1, y_hat_mb.shape[-1])[:, :t]
    sc, mag = multi_resolution_stft_loss(y_hat, y_flat, fft_sizes, hop_sizes, win_lengths)
    return sc + mag
