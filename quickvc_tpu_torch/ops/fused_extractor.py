"""HuBERT's extractor front: the closed-form GroupNorm affine and kernel K7.

The port of ``quickvc_tpu/ops/fused_extractor.py``.

:func:`groupnorm_affine_closed_form` (plain PyTorch, not a kernel) drives
the default ``faststats`` front and feeds K7. conv0 (k=10, stride 5, no
bias) is linear in the wave, so the per-(batch, channel) mean and variance
of its output over time follow from the 10-vector S = sum_t F[t] and the
10x10 second moment C = F^T F of the (Tc, 10) frame matrix F:

    mean = S @ W0 / Tc,   E[x^2]_c = W0[:, c]^T C W0[:, c] / Tc

an O(T) pass over the wave instead of a reduction over conv0's output.

Kernel K7 (``csrc/fused_extractor.cu``) replaces the TPU kernel
``fused_extractor_front``: conv0 -> that affine -> GELU -> conv1 (k=3,
stride 2, no bias) -> GELU in one pass, conv0's output never leaving the
chip, conv1 an implicit GEMM on TF32 tensor cores in 3xTF32 fed by conv0's
output as the kernel produces it from the wave. :func:`extractor_front`
takes the plain version,
:func:`extractor_front_reference`, for a CPU tensor and launches the kernel
for a CUDA tensor (or raises). Layouts are the JAX package's: wave (B, T) in,
(B, n1, C) out with n1 = ((T - 10) // 5 + 1 - 3) // 2 + 1; the weights keep
torch's layouts, conv0 (C, 1, 10) and conv1 (C, C, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (KernelStats, bf16_item, check, library, refuse_grad,
                                         require_cuda, require_dtype, stream_ptr)

STATS = KernelStats("extractor_front")
BF16_MODE = bf16_item("A19")   # the `pallas` encode front at bf16


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


def front_rows(t: int) -> int:
    """n1, the rows conv1 gives for a wave of t samples."""
    return ((t - 10) // 5 + 1 - 3) // 2 + 1


def extractor_front_reference(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, w1: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """conv0 -> closed-form affine -> exact GELU -> conv1 -> GELU, (B, n1, C)."""
    scale, shift = groupnorm_affine_closed_form(wav, w0, gamma, beta, eps)
    y = F.conv1d(wav[:, None], w0, stride=5)
    x = F.gelu(y * scale[:, :, None] + shift[:, :, None])
    return F.gelu(F.conv1d(x, w1, stride=2)).transpose(1, 2)


def extractor_front_kernel(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, w1: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """Launch K7 on float32 CUDA tensors; the affine is computed first in PyTorch."""
    require_cuda("extractor_front", wav, w0, gamma, beta, w1, why=BF16_MODE)
    b, t = wav.shape
    c = w0.shape[0]
    n1 = front_rows(t)
    if (w0.shape != (c, 1, 10) or w1.shape != (c, c, 3) or gamma.shape != (c,)
            or beta.shape != (c,) or c % 8 or n1 < 1):
        raise ValueError(f"extractor_front: need wav (B, T >= 20), conv0 (C, 1, 10), conv1 "
                         f"(C, C, 3), C % 8 == 0; got {tuple(wav.shape)} {tuple(w0.shape)} "
                         f"{tuple(w1.shape)}")
    scale, shift = groupnorm_affine_closed_form(wav, w0, gamma, beta, eps)
    # einsum may give (B, C) in channel-major strides; the kernel reads row-major
    scale, shift = scale.contiguous(), shift.contiguous()
    wav, w0 = wav.contiguous(), w0.contiguous()
    w1t = w1.permute(2, 1, 0).contiguous()          # [tap][in][out]
    out = torch.empty((b, n1, c), device=wav.device, dtype=torch.float32)
    if any(z.data_ptr() % 16 for z in (w0, scale, shift, w1t)):
        raise ValueError("extractor_front: conv0's weight must start on a 16-byte boundary")
    check(library().qvc_extractor_front(
        wav.data_ptr(), w0.data_ptr(), scale.data_ptr(), shift.data_ptr(), w1t.data_ptr(),
        out.data_ptr(), b, t, c, n1, stream_ptr(wav)), "extractor_front kernel")
    STATS.count()
    return out


def extractor_front(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, w1: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The extractor front: plain on CPU, K7 on CUDA. No backward."""
    refuse_grad("extractor_front", wav, w0, gamma, beta, w1)
    require_dtype("extractor_front", wav, why=BF16_MODE)
    if wav.device.type == "cpu":
        return extractor_front_reference(wav, w0, gamma, beta, w1, eps)
    return extractor_front_kernel(wav, w0, gamma, beta, w1, eps)
