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

A bf16 wave takes K7's bf16 mode, as the JAX kernel computes a bf16 wave:
conv0 and conv1 on bf16 operands (the weights rounded to bf16 once a call;
the affine from conv0's unrounded weight) summed in float32, each
pre-activation rounded to bf16, the tanh GELU in float32 and rounded
again, a bf16 output. It has two bodies: at HuBERT's width (C = 512,
:func:`takes_wgmma`) the persistent TMA + ``wgmma`` body of
``csrc/extractor_wgmma.cu`` (``qvc_extractor_front_bf16_wgmma``, planned by
:func:`front_wgmma_plan`; :func:`front_h_row` and :func:`front_h_offset`
are the host twins of its layout of h), at any other width the ``mma.sync``
body of ``csrc/fused_extractor.cu`` (``qvc_extractor_front_bf16``, conv1's
weight in :func:`bf16_channel_order`); the host routes by shape before the
launch, with no fallback. :data:`STATS` counts float32 launches,
:data:`BF16_STATS` bf16 ones (either body), :data:`WGMMA_STATS` those of
them on the ``wgmma`` body.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (F32_BF16, KernelStats, check, device_sms, library,
                                         refuse_grad, require_cuda, require_device, require_dtype,
                                         stream_ptr)

STATS = KernelStats("extractor_front")
BF16_STATS = KernelStats("extractor_front_bf16")
WGMMA_STATS = KernelStats("extractor_front_bf16_wgmma")   # of those, on the wgmma body
BF16_GROUP = 16   # the mma.sync bf16 body's in-channel slice and output-channel group
# csrc/extractor_wgmma.cu: C, BM, KC, HROWS, HEVEN, CLUSTER
WGMMA_CHANNELS = 512   # the wgmma body's only width: two consumer warpgroups of 256 channels
WGMMA_ROWS = 64        # output rows a CTA's tile
WGMMA_SLICE = 64       # in-channels a slice of h and a stage of conv1's weight
WGMMA_HROWS = 2 * WGMMA_ROWS + 1   # conv0 rows a tile reads: even ones first, then odd
WGMMA_CLUSTER = 2      # CTAs sharing each weight stage by TMA multicast


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
    """conv0 -> closed-form affine -> GELU -> conv1 -> GELU, (B, n1, C) in the
    wave's dtype: exact erf GELU in float32; at bf16 the TPU kernel's bf16
    mode (``quickvc_tpu/ops/fused_extractor.py:92-110``): bf16 operands, the
    affine from conv0's unrounded weight, float32 sums, each pre-activation
    rounded to bf16 before the tanh GELU and its result rounded again."""
    scale, shift = groupnorm_affine_closed_form(wav, w0, gamma, beta, eps)
    if wav.dtype == torch.bfloat16:
        def act(z):   # float32 pre-activation -> bf16 -> tanh GELU (in float32) -> bf16
            return F.gelu(z.bfloat16(), approximate="tanh")

        y = F.conv1d(wav.float()[:, None], w0.bfloat16().float(), stride=5)
        x = act(y * scale[:, :, None] + shift[:, :, None])
        return act(F.conv1d(x.float(), w1.bfloat16().float(), stride=2)).transpose(1, 2)
    y = F.conv1d(wav[:, None], w0, stride=5)
    x = F.gelu(y * scale[:, :, None] + shift[:, :, None])
    return F.gelu(F.conv1d(x, w1, stride=2)).transpose(1, 2)


def bf16_channel_order(c: int) -> torch.Tensor:
    """The output channels in the order the bf16 kernel's w1t holds them:
    within each group of 16, position q < 8 is channel 2q and 8 + q is 2q + 1
    (so that a lane's accumulators hold adjacent channels)."""
    q = torch.arange(BF16_GROUP)
    within = torch.where(q < BF16_GROUP // 2, 2 * q, 2 * q - BF16_GROUP + 1)
    return (torch.arange(0, c, BF16_GROUP)[:, None] + within).reshape(-1)


def takes_wgmma(c: int) -> bool:
    """Whether a bf16 call goes to the TMA + wgmma body: C == 512, its two
    consumer warpgroups' 256 output channels each (every other width takes
    the mma.sync body)."""
    return c == WGMMA_CHANNELS


class FrontPlan(NamedTuple):
    """The wgmma body's persistent grid: ``clusters`` clusters of
    WGMMA_CLUSTER CTAs; cluster k takes the tile pairs k, k + clusters, ...,
    CTA r of it tile 2 p + r of ``tiles`` (tile i: batch item i //
    tiles_per_batch, output rows from WGMMA_ROWS (i % tiles_per_batch)); a
    pair's second tile past the last stores nothing."""
    tiles_per_batch: int
    tiles: int
    pairs: int
    clusters: int

    def items(self, cluster: int) -> list[tuple[int, int]]:
        """The (tile of rank 0, tile of rank 1) pairs cluster ``cluster`` walks."""
        return [(2 * p, 2 * p + 1) for p in range(cluster, self.pairs, self.clusters)]


def front_wgmma_plan(batch: int, n1: int, sm_count: int = 132) -> FrontPlan:
    """The wgmma body's tiles at (batch, n1): ceil(n1 / 64) a batch item, in
    pairs, one cluster of two CTAs (two SMs) a pair up to the card's
    sm_count // 2 clusters."""
    if batch < 1 or n1 < 1:
        raise ValueError(f"front_wgmma_plan: need batch and n1 >= 1, got {batch}, {n1}")
    per = -(-n1 // WGMMA_ROWS)
    tiles = batch * per
    pairs = -(-tiles // 2)
    return FrontPlan(per, tiles, pairs, min(pairs, sm_count // WGMMA_CLUSTER))


def front_h_row(t: int) -> int:
    """The slice row of a tile's conv0 row t (0 .. 128): even rows first, so
    tap j of output row u (conv0 row 2 u + j) reads row u (j 0), 65 + u (j
    1) or u + 1 (j 2)."""
    return WGMMA_ROWS + 1 + t // 2 if t % 2 else t // 2


def front_h_offset(row: int, c: int) -> int:
    """The byte offset of channel c (0 .. 63) of slice row ``row`` in a slice
    of h: 128-byte rows, the 16-byte chunk c // 8 at chunk (c // 8) ^ (row %
    8), so that any 8 consecutive rows' same chunk hit 8 bank groups."""
    return row * 128 + (((c >> 3) ^ (row & 7)) << 4) + ((c & 7) << 1)


def extractor_front_kernel(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, w1: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """Launch K7 on CUDA tensors: a float32 wave and float32 weights, or a bf16
    wave (weights of any float dtype, rounded to bf16 for the products; the
    body :func:`takes_wgmma` picks); the affine is computed first in
    PyTorch."""
    bf16 = wav.dtype == torch.bfloat16
    if bf16:
        require_device("extractor_front", wav, w0, gamma, beta, w1)
    else:
        require_cuda("extractor_front", wav, w0, gamma, beta, w1, dtypes=F32_BF16)
    b, t = wav.shape
    c = w0.shape[0]
    n1 = front_rows(t)
    group = BF16_GROUP if bf16 else 8
    if (w0.shape != (c, 1, 10) or w1.shape != (c, c, 3) or gamma.shape != (c,)
            or beta.shape != (c,) or c % group or n1 < 1):
        raise ValueError(f"extractor_front: need wav (B, T >= 20), conv0 (C, 1, 10), conv1 "
                         f"(C, C, 3), C % {group} == 0; got {tuple(wav.shape)} "
                         f"{tuple(w0.shape)} {tuple(w1.shape)}")
    scale, shift = groupnorm_affine_closed_form(wav, w0, gamma, beta, eps)
    # einsum may give (B, C) in channel-major strides; the kernel reads row-major
    scale, shift = scale.contiguous(), shift.contiguous()
    if bf16:
        return _extractor_front_bf16(wav, w0, scale, shift, w1, n1)
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


def _extractor_front_bf16(wav: torch.Tensor, w0: torch.Tensor, scale: torch.Tensor,
                          shift: torch.Tensor, w1: torch.Tensor, n1: int) -> torch.Tensor:
    """K7's bf16 mode: conv0's weight rounded to bf16 (held as float32
    values); conv1's as bf16 [tap][out][in] for the wgmma body, [tap][in][out]
    in :func:`bf16_channel_order` for the mma.sync body."""
    b, t = wav.shape
    c = w0.shape[0]
    wav = wav.contiguous()
    w0b = w0.reshape(c, 10).bfloat16().float().contiguous()
    wgmma = takes_wgmma(c)
    if wgmma:
        w1t = w1.bfloat16().permute(2, 0, 1).contiguous()
    else:
        w1t = w1.bfloat16().permute(2, 1, 0)[:, :, bf16_channel_order(c).to(w1.device)]
        w1t = w1t.contiguous()
    out = torch.empty((b, n1, c), device=wav.device, dtype=torch.bfloat16)
    if any(z.data_ptr() % 16 for z in (w0b, scale, shift, w1t)):
        raise ValueError("extractor_front: the kernel's weights must start on a 16-byte boundary")
    args = (wav.data_ptr(), w0b.data_ptr(), scale.data_ptr(), shift.data_ptr(), w1t.data_ptr(),
            out.data_ptr(), b, t, c, n1)
    if wgmma:
        plan = front_wgmma_plan(b, n1, device_sms(wav.device.index or 0))
        check(library().qvc_extractor_front_bf16_wgmma(*args, plan.clusters, stream_ptr(wav)),
              "extractor_front kernel (bf16, wgmma)")
        WGMMA_STATS.count()
    else:
        check(library().qvc_extractor_front_bf16(*args, stream_ptr(wav)),
              "extractor_front kernel (bf16)")
    BF16_STATS.count()
    return out


def extractor_front(wav: torch.Tensor, w0: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, w1: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The extractor front: plain on CPU, K7 on CUDA; a float32 or bf16 wave,
    the output in its dtype. No backward."""
    refuse_grad("extractor_front", wav, w0, gamma, beta, w1)
    require_dtype("extractor_front", wav, dtypes=F32_BF16)
    if wav.device.type == "cpu":
        return extractor_front_reference(wav, w0, gamma, beta, w1, eps)
    return extractor_front_kernel(wav, w0, gamma, beta, w1, eps)
