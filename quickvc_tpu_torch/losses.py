"""GAN, feature-matching, KL and multi-resolution STFT losses (port of
``quickvc_tpu/losses.py``, reference ``losses.py``).

Per-discriminator terms come back stacked as tensors, not Python floats, so
computing them needs no host sync.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from quickvc_tpu_torch.dsp.stft import magnitude_stft


def own_rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``sum_ranks`` for a call that sees every row itself: (``t``, 1)."""
    return t, 1


def feature_loss(fmap_r, fmap_g, sum_ranks: Callable = own_rows) -> torch.Tensor:
    """L1 feature matching against detached real features, x2.

    Each term is a mean over the rows of every rank (``sum_ranks``: ``t ->
    (the sum of t over the ranks, their number)``; by default this call's
    rows), taken in float32 and rounded once to the feature maps' dtype (bf16
    at ``precision: "bf16"``), as JAX's float32 trainer takes it over the
    global batch. Its gradient is this rank's mean's, which the gradient
    reduce averages into the global one."""
    terms = [torch.abs(rl.detach() - gl)
             for dr, dg in zip(fmap_r, fmap_g) for rl, gl in zip(dr, dg)]
    means = [t.sum(dtype=torch.float32) / t.numel() for t in terms]
    sums, world = sum_ranks(torch.stack(means).detach())
    loss = 0.0
    for s, m, t in zip(sums, means, terms):
        loss = loss + (s / world + (m - m.detach())).to(t.dtype)
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


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor, fft_sizes: Sequence[int],
                               hop_sizes: Sequence[int], win_lengths: Sequence[int],
                               sum_ranks: Callable = own_rows):
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

    Each resolution's spectral convergence is one ratio over the rows of
    every rank, ``sqrt(sum_r ||Y_r - X_r||^2 / sum_r ||Y_r||^2)``, the two
    sums taken over the ranks by ``sum_ranks`` (as :func:`feature_loss`
    takes it; one call for every resolution), as a float32 data-parallel
    JAX step computes it over the global batch. Its gradient on this rank
    is the global ratio's on this rank's rows times the number of ranks,
    since the gradient reduce then takes the mean over them; ``y`` takes
    none. The log magnitude is a mean, so equal per-rank batches average to
    the global one as they are.
    """
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    num, den, mag_total = [], [], 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        x_mag = magnitude_stft(x.double(), n_fft, hop, win)
        y_mag = magnitude_stft(y.double(), n_fft, hop, win)
        num.append(torch.sum((y_mag - x_mag) ** 2))
        den.append(torch.sum(y_mag.detach() ** 2))
        mag_total = mag_total + torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    num = torch.stack(num)
    (num_all, den_all), world = sum_ranks(torch.stack([num.detach(), torch.stack(den)]))
    # the global sums' values, with the world times this rank's gradient
    sc_total = torch.sqrt((num_all + world * (num - num.detach())) / den_all).sum()
    n = len(fft_sizes)
    return (sc_total / n).to(dtype), (mag_total / n).to(dtype)


def subband_stft_loss(y_mb: torch.Tensor, y_hat_mb: torch.Tensor, fft_sizes: Sequence[int],
                      hop_sizes: Sequence[int], win_lengths: Sequence[int],
                      sum_ranks: Callable = own_rows) -> torch.Tensor:
    """Sub-band MR-STFT loss, sc + log-mag: the target bands ``y_mb`` and the
    generated ones ``y_hat_mb``, channels-first (B, Band, T) each, the bands
    folded into the batch and the generated ones cropped to the target's
    length (``quickvc_tpu/losses.py:70-83`` takes them channels-last);
    ``sum_ranks`` as :func:`multi_resolution_stft_loss` takes it."""
    t = y_mb.shape[-1]
    y_flat = y_mb.reshape(-1, t)
    y_hat = y_hat_mb.reshape(-1, y_hat_mb.shape[-1])[:, :t]
    sc, mag = multi_resolution_stft_loss(y_hat, y_flat, fft_sizes, hop_sizes, win_lengths,
                                         sum_ranks)
    return sc + mag
