"""Kernels K2, K9 and K10: multi-head attention on three layouts (``csrc/fused_attention.cu``).

Replace the TPU kernels of ``quickvc_tpu/ops/fused_attention.py``:

- K2 :func:`attention_packed` (``fused_attention_packed``): q, k and v are
  (B, T, H*D) as the in-projection produces them; the output is (B, T, H*D),
  ready for the out-projection.
- K9 :func:`attention_packed_aligned` (``fused_attention_packed_aligned``):
  (B, T, H*128), each head's values in the first lanes of its 128-lane slot
  and zeros in the rest; padded output lanes come out exactly zero.
- K10 :func:`attention` (``fused_attention``): (B, H, T, D).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernels take a head dim in :data:`HEAD_DIMS` and float32 (one
3xTF32 body, ``csrc/fused_attention.cuh``, serves all three and K8's layer)
or bfloat16 q, k and v, which run the single-pass bf16 bodies of
``csrc/fused_attention_bf16.cuh`` into a bf16 output, as the JAX kernels
compute bf16 inputs: the TMA + ``wgmma`` body at head dims 64 and 128 on
views TMA takes, the ``mma.sync`` body otherwise, as
:func:`bf16_attention_plan` decides and hands over. Each dispatcher counts
only its own launches, by dtype: :data:`STATS` and :data:`BF16_STATS` (K2),
:data:`ALIGNED_STATS` and :data:`ALIGNED_BF16_STATS` (K9),
:data:`HEADED_STATS` and :data:`HEADED_BF16_STATS` (K10).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from quickvc_tpu_torch.ops._cuda import (F32_BF16, KernelStats, check, device_sms, library,
                                         refuse_grad, require_cuda, require_dtype, stream_ptr)

STATS = KernelStats("attention_packed")                  # K2, float32
BF16_STATS = KernelStats("attention_packed_bf16")        # K2, bfloat16
ALIGNED_STATS = KernelStats("attention_packed_aligned")  # K9, float32
ALIGNED_BF16_STATS = KernelStats("attention_packed_aligned_bf16")  # K9, bfloat16
HEADED_STATS = KernelStats("attention")                  # K10, float32
HEADED_BF16_STATS = KernelStats("attention_bf16")        # K10, bfloat16
HEAD_DIMS = (16, 32, 64, 128)  # compiled into the body (HuBERT-base: 768 / 12 = 64)
HEAD_PAD = 128                 # K9's lanes per head

# csrc/fused_attention_bf16.cuh: the wgmma body's compiled configurations,
# (head dim, consumer warpgroups) -> (keys a tile, ring stages, CTAs an SM
# its launch bounds leave registers for); each warpgroup takes 64 query rows
WGMMA_CONFIGS = {(64, 1): (64, 2, 3), (64, 2): (64, 2, 2), (128, 1): (32, 3, 3)}
MMA_SYNC_BLOCKS = 2        # the mma.sync body's launch bounds: 2 blocks an SM
SM_SMEM = 233472           # shared memory an H100 SM holds (228 KB) ...
CTA_SMEM_RESERVED = 1024   # ... of which each CTA takes 1 KB for itself
SM_THREADS = 2048


class AttentionPlan(NamedTuple):
    """How the bf16 body runs one call: ``body`` "wgmma" or "mma_sync";
    ``rows`` query rows a CTA (64 a consumer warpgroup), ``bn`` keys a tile,
    ``stages`` the K/V ring's depth, ``smem`` a CTA's dynamic shared memory;
    ``ctas`` = ceil(T / rows) x heads x batch, ``per_sm`` the CTAs an SM holds
    by shared memory, threads and the launch bounds' registers, ``waves`` =
    ceil(ctas / (per_sm x SMs))."""
    body: str
    rows: int
    bn: int
    stages: int
    smem: int
    ctas: int
    per_sm: int
    waves: int

    def c_args(self) -> tuple[int, int, int]:
        """(rows, bn, stages) as the C entries take them (rows 0: mma.sync)."""
        return (self.rows if self.body == "wgmma" else 0, self.bn, self.stages)

    def tiles(self, t_len: int) -> list[range]:
        """The query rows of each CTA of one (batch, head), in launch order."""
        return [range(r, min(r + self.rows, t_len)) for r in range(0, t_len, self.rows)]


def _plan(body: str, batch: int, heads: int, t_len: int, rows: int, bn: int, stages: int,
          smem: int, threads: int, min_blocks: int, sm_count: int) -> AttentionPlan:
    ctas = -(-t_len // rows) * heads * batch
    per_sm = min(SM_SMEM // (smem + CTA_SMEM_RESERVED), SM_THREADS // threads, min_blocks)
    return AttentionPlan(body, rows, bn, stages, smem, ctas, per_sm,
                         -(-ctas // (per_sm * sm_count)))


def bf16_attention_plan(batch: int, heads: int, t_len: int, head_dim: int,
                        sm_count: int = 132, tma: bool = True) -> AttentionPlan:
    """The bf16 body and configuration for (batch, heads, T, D) on a card of
    ``sm_count`` SMs.

    Head dims 64 and 128 on views TMA takes (``tma``: 16-byte aligned
    pointers and strides) run the TMA + ``wgmma`` body in one of
    :data:`WGMMA_CONFIGS`: of those, the fewest waves of CTAs, then the
    fewest query rows the busiest SM takes (ceil(ctas / SMs) x rows), then
    the fewest CTAs (each reads every K/V tile of its head once). Head dims
    16 and 32, and other views, run the ``mma.sync`` body (64 rows a block,
    64-key tiles, two buffers).
    """
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"bf16_attention_plan: head dim {head_dim} is not one of {HEAD_DIMS}")
    if head_dim not in (64, 128) or not tma:
        smem = 4 * 64 * (head_dim + 8) * 2
        return _plan("mma_sync", batch, heads, t_len, 64, 64, 2, smem, 128, MMA_SYNC_BLOCKS,
                     sm_count)
    plans = []
    for (d, groups), (bn, stages, min_blocks) in WGMMA_CONFIGS.items():
        if d == head_dim:
            rows = 64 * groups
            # Q, the K and V rings, the 1 KB alignment slack
            smem = rows * d * 2 + 2 * stages * bn * d * 2 + 1024
            plans.append(_plan("wgmma", batch, heads, t_len, rows, bn, stages, smem,
                               128 * groups + 32, min_blocks, sm_count))
    return min(plans, key=lambda p: (p.waves, -(-p.ctas // sm_count) * p.rows, p.ctas))


def _tma_ok(*views: tuple[torch.Tensor, tuple[int, int, int]]) -> bool:
    """Whether TMA takes these (tensor, (batch, head, row) strides) views:
    16-byte aligned, every stride a whole number of 16-byte chunks, and the
    three in one order of strides (one coordinate order serves all)."""
    orders = {tuple(sorted(range(3), key=lambda i: st[::-1][i])) for _, st in views}
    return len(orders) == 1 and all(z.data_ptr() % 16 == 0 and all(x % 8 == 0 and x > 0
                                                                    for x in st)
                                    for z, st in views)


def attention_bf16_occupancy(head_dim: int, plan: AttentionPlan) -> dict:
    """The compiled body a plan names, on the card: the CTAs an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), a thread's
    registers and a CTA's dynamic shared memory."""
    out = (ctypes.c_int * 3)()
    check(library().qvc_attention_bf16_occupancy(head_dim, *plan.c_args(), out),
          "attention bf16 occupancy")
    return {"ctas_per_sm": out[0], "registers": out[1], "smem": out[2]}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, D), float32 scores and softmax.

    At bf16 it computes what the TPU kernels K9 and K10 compute (one bf16
    pass, ``quickvc_tpu/ops/fused_attention.py:39-56, 137-161``): the
    products of bf16 values summed in float32, p rounded to bf16 for the
    product with v, which sums in float32, and the output rounded to bf16."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(v.dtype)


def _heads(z: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, H*D) -> a (B, H, T, D) view."""
    b, t, hd = z.shape
    return z.reshape(b, t, num_heads, hd // num_heads).transpose(1, 2)


def _packed(o: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = o.shape
    return o.transpose(1, 2).reshape(b, t, h * d)


def attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q_h k_h^T * scale) v_h per head, float32 scores, packed layout.

    At bf16 it computes what the JAX package computes off the TPU
    (``quickvc_tpu/ops/fused_attention.py:220-223``): the scores come out of
    the bf16 product rounded to bf16, the softmax runs in float32, p is
    rounded to bf16 for the bf16 product with v."""
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)).float() * scale
    return _packed(torch.softmax(s, dim=-1).to(v.dtype) @ _heads(v, num_heads))


def attention_packed_aligned_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       num_heads: int, scale: float,
                                       head_pad: int = HEAD_PAD) -> torch.Tensor:
    """:func:`attention_reference` over the padded heads; zero padded q/k/v
    lanes give zero output lanes."""
    if q.shape[-1] != num_heads * head_pad:
        raise ValueError(f"attention_packed_aligned: need (B, T, {num_heads}*{head_pad}), "
                         f"got {tuple(q.shape)}")
    return _packed(attention_reference(*(_heads(z, num_heads) for z in (q, k, v)), scale))


def _require_same(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dims: int,
                  layout: str) -> None:
    if (q.dim() != dims or k.shape != q.shape or v.shape != q.shape
            or any(z.stride(-1) != 1 for z in (q, k, v))):
        raise ValueError(f"{name}: need {layout} q/k/v of one shape with unit stride along "
                         f"the last dim, got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")


def attention_packed_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Launch K2 on float32 or bfloat16 CUDA (B, T, H*D) views whose last dim is
    unit-stride; the output has their dtype."""
    dtype = require_cuda("attention_packed", q, k, v, dtypes=F32_BF16)
    _require_same("attention_packed", q, k, v, 3, "(B, T, H*D)")
    b, t, hd = q.shape
    d = hd // num_heads
    if d * num_heads != hd or d not in HEAD_DIMS:
        raise ValueError(f"attention_packed: head dim {hd}/{num_heads} is not one of "
                         f"{HEAD_DIMS}, the ones the kernel is built for")
    out = torch.empty((b, t, hd), device=q.device, dtype=dtype)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale))
    if dtype == torch.bfloat16:
        plan = _packed_plan(q, k, v, num_heads, d)
        check(library().qvc_attention_packed_bf16(*args, *plan.c_args(), stream_ptr(q)),
              f"attention_packed kernel ({dtype}, {plan.body})")
        BF16_STATS.count()
    else:
        check(library().qvc_attention_packed(*args, stream_ptr(q)),
              f"attention_packed kernel ({dtype})")
        STATS.count()
    return out


def _packed_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                 d: int) -> AttentionPlan:
    """The bf16 plan of (B, T, H*D) views, head h at column h*D."""
    b, t, _ = q.shape
    tma = _tma_ok(*((z, (z.stride(0), d, z.stride(1))) for z in (q, k, v)))
    return bf16_attention_plan(b, num_heads, t, d, device_sms(q.device.index or 0), tma)


def attention_packed_aligned_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    num_heads: int, scale: float,
                                    head_pad: int = HEAD_PAD) -> torch.Tensor:
    """Launch K9 on float32 or bfloat16 CUDA (B, T, H*128) views whose last dim
    is unit-stride; the output has their dtype."""
    dtype = require_cuda("attention_packed_aligned", q, k, v, dtypes=F32_BF16)
    _require_same("attention_packed_aligned", q, k, v, 3, "(B, T, H*128)")
    b, t, hp = q.shape
    if head_pad != HEAD_PAD or hp != num_heads * HEAD_PAD:
        raise ValueError(f"attention_packed_aligned: the kernel takes heads padded to "
                         f"{HEAD_PAD} lanes, got head_pad={head_pad} and {hp} columns for "
                         f"{num_heads} heads")
    out = torch.empty((b, t, hp), device=q.device, dtype=dtype)
    # K2's entry at D = 128: the padded slots are heads of 128 lanes
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, num_heads,
            HEAD_PAD, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), float(scale))
    if dtype == torch.bfloat16:
        plan = _packed_plan(q, k, v, num_heads, HEAD_PAD)
        check(library().qvc_attention_packed_bf16(*args, *plan.c_args(), stream_ptr(q)),
              f"attention_packed_aligned kernel ({dtype}, {plan.body})")
        ALIGNED_BF16_STATS.count()
    else:
        check(library().qvc_attention_packed(*args, stream_ptr(q)),
              f"attention_packed_aligned kernel ({dtype})")
        ALIGNED_STATS.count()
    return out


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Launch K10 on float32 or bfloat16 CUDA (B, H, T, D) views whose last dim
    is unit-stride; the output is a contiguous (B, H, T, D) of their dtype."""
    dtype = require_cuda("attention", q, k, v, dtypes=F32_BF16)
    _require_same("attention", q, k, v, 4, "(B, H, T, D)")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} is not one of {HEAD_DIMS}, the ones "
                         "the kernel is built for")
    out = torch.empty((b, h, t, d), device=q.device, dtype=dtype)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale))
    if dtype == torch.bfloat16:
        plan = bf16_attention_plan(b, h, t, d, device_sms(q.device.index or 0),
                                   _tma_ok(*((z, z.stride()[:3]) for z in (q, k, v))))
        check(library().qvc_attention_headed_bf16(*args, *plan.c_args(), stream_ptr(q)),
              f"attention kernel ({dtype}, {plan.body})")
        HEADED_BF16_STATS.count()
    else:
        check(library().qvc_attention_headed(*args, stream_ptr(q)), f"attention kernel ({dtype})")
        HEADED_STATS.count()
    return out


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float) -> torch.Tensor:
    """Packed MHA core (K2): plain on CPU, the kernel on CUDA; float32 or
    bfloat16, q, k and v of one dtype. No backward."""
    refuse_grad("attention_packed", q, k, v)
    require_dtype("attention_packed", q, k, v, dtypes=F32_BF16)
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, scale)
    return attention_packed_kernel(q, k, v, num_heads, scale)


def attention_packed_aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             num_heads: int, scale: float,
                             head_pad: int = HEAD_PAD) -> torch.Tensor:
    """Packed MHA over heads zero-padded to ``head_pad`` lanes (K9): plain on
    CPU, the kernel on CUDA; float32 or bfloat16. No backward."""
    refuse_grad("attention_packed_aligned", q, k, v)
    require_dtype("attention_packed_aligned", q, k, v, dtypes=F32_BF16)
    if q.device.type == "cpu":
        return attention_packed_aligned_reference(q, k, v, num_heads, scale, head_pad)
    return attention_packed_aligned_kernel(q, k, v, num_heads, scale, head_pad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """MHA on (B, H, T, D) (K10): plain on CPU, the kernel on CUDA; float32 or
    bfloat16. No backward."""
    refuse_grad("attention", q, k, v)
    require_dtype("attention", q, k, v, dtypes=F32_BF16)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return attention_kernel(q, k, v, scale)
