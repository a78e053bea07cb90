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
3xTF32 body, ``csrc/fused_attention.cuh``, serves all three and K8's layer);
K2 also takes bfloat16 q, k and v, which run the single-pass bf16 body of
``csrc/fused_attention_bf16.cuh`` into a bf16 output, as the JAX kernel
computes bf16 inputs. K9 and K10 refuse bf16 on both devices (ROADMAP A21).
Each dispatcher counts only its own launches, in :data:`STATS` (K2 float32),
:data:`BF16_STATS` (K2 bf16), :data:`ALIGNED_STATS` and :data:`HEADED_STATS`.
"""

from __future__ import annotations

import torch

from quickvc_tpu_torch.ops._cuda import (F32_BF16, KernelStats, bf16_item, check, library,
                                         refuse_grad, require_cuda, require_dtype, stream_ptr)

STATS = KernelStats("attention_packed")                  # K2, float32
BF16_STATS = KernelStats("attention_packed_bf16")        # K2, bfloat16
ALIGNED_STATS = KernelStats("attention_packed_aligned")  # K9
HEADED_STATS = KernelStats("attention")                  # K10
HEAD_DIMS = (16, 32, 64, 128)  # compiled into the body (HuBERT-base: 768 / 12 = 64)
HEAD_PAD = 128                 # K9's lanes per head
BF16_MODE = bf16_item("A21")   # K9 and K10 through the ops API at bf16


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, T, D), float32 scores."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


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
    """:func:`attention_reference` over the padded heads, as the JAX package's
    off-TPU path computes it; zero padded q/k/v lanes give zero output lanes."""
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
    bf16 = dtype == torch.bfloat16
    out = torch.empty((b, t, hd), device=q.device, dtype=dtype)
    entry = library().qvc_attention_packed_bf16 if bf16 else library().qvc_attention_packed
    check(entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, num_heads, d,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                v.stride(1), float(scale), stream_ptr(q)),
          f"attention_packed kernel ({dtype})")
    (BF16_STATS if bf16 else STATS).count()
    return out


def attention_packed_aligned_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    num_heads: int, scale: float,
                                    head_pad: int = HEAD_PAD) -> torch.Tensor:
    """Launch K9 on float32 CUDA (B, T, H*128) views whose last dim is unit-stride."""
    require_cuda("attention_packed_aligned", q, k, v, why=BF16_MODE)
    _require_same("attention_packed_aligned", q, k, v, 3, "(B, T, H*128)")
    b, t, hp = q.shape
    if head_pad != HEAD_PAD or hp != num_heads * HEAD_PAD:
        raise ValueError(f"attention_packed_aligned: the kernel takes heads padded to "
                         f"{HEAD_PAD} lanes, got head_pad={head_pad} and {hp} columns for "
                         f"{num_heads} heads")
    out = torch.empty((b, t, hp), device=q.device, dtype=torch.float32)
    # K2's entry at D = 128: the padded slots are heads of 128 lanes
    check(library().qvc_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, num_heads, HEAD_PAD,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), float(scale), stream_ptr(q)), "attention_packed_aligned kernel")
    ALIGNED_STATS.count()
    return out


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Launch K10 on float32 CUDA (B, H, T, D) views whose last dim is unit-stride;
    the output is a contiguous (B, H, T, D)."""
    require_cuda("attention", q, k, v, why=BF16_MODE)
    _require_same("attention", q, k, v, 4, "(B, H, T, D)")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {d} is not one of {HEAD_DIMS}, the ones "
                         "the kernel is built for")
    out = torch.empty((b, h, t, d), device=q.device, dtype=torch.float32)
    check(library().qvc_attention_headed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(scale), stream_ptr(q)),
        "attention kernel")
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
    CPU, the kernel on CUDA; float32 only. No backward."""
    refuse_grad("attention_packed_aligned", q, k, v)
    require_dtype("attention_packed_aligned", q, k, v, why=BF16_MODE)
    if q.device.type == "cpu":
        return attention_packed_aligned_reference(q, k, v, num_heads, scale, head_pad)
    return attention_packed_aligned_kernel(q, k, v, num_heads, scale, head_pad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """MHA on (B, H, T, D) (K10): plain on CPU, the kernel on CUDA; float32
    only. No backward."""
    refuse_grad("attention", q, k, v)
    require_dtype("attention", q, k, v, why=BF16_MODE)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return attention_kernel(q, k, v, scale)
