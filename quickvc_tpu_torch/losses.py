"""GAN, feature-matching and KL losses (port of ``quickvc_tpu/losses.py:18-44``,
reference ``losses.py``).

Per-discriminator terms come back stacked as tensors, not Python floats, so
computing them needs no host sync.
"""

from __future__ import annotations

import torch


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
