"""Closed-form GroupNorm affine of HuBERT's first conv (plain PyTorch, not a kernel).

The port of ``quickvc_tpu/ops/fused_extractor.py:groupnorm_affine_closed_form``,
which drives the default ``faststats`` extractor front. conv0 (k=10,
stride 5, no bias) is linear in the wave, so the per-(batch, channel) mean
and variance of its output over time follow from the 10-vector S = sum_t F[t]
and the 10x10 second moment C = F^T F of the (Tc, 10) frame matrix F:

    mean = S @ W0 / Tc,   E[x^2]_c = W0[:, c]^T C W0[:, c] / Tc

an O(T) pass over the wave instead of a reduction over conv0's output.
"""

from __future__ import annotations

import torch


def groupnorm_affine_closed_form(wav: torch.Tensor, conv0_weight: torch.Tensor,
                                 gamma: torch.Tensor, beta: torch.Tensor,
                                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift), both (B, ch) float32, with
    ``GroupNorm(ch, ch)(conv0(wav)) == conv0(wav) * scale + shift``.

    wav: (B, T); conv0_weight: torch layout (ch, 1, 10).
    """
    b, t = wav.shape
    tc = (t - 10) // 5 + 1
    nt = tc + 1
    r = wav[:, : 5 * nt].reshape(b, nt, 5).float()
    fmat = torch.cat([r[:, :-1], r[:, 1:]], dim=-1)            # (B, Tc, 10)
    w0 = conv0_weight[:, 0, :].T.float()                        # (10, ch)
    s_vec = fmat.sum(dim=1)                                     # (B, 10)
    c_mat = torch.einsum("btj,btk->bjk", fmat, fmat)            # (B, 10, 10)
    mean = (s_vec @ w0) / tc
    ex2 = torch.einsum("jc,bjk,kc->bc", w0, c_mat, w0) / tc
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    return scale, shift
