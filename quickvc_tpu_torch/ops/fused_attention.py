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
raises. The kernels take float32 and a head dim in :data:`HEAD_DIMS`. One
body (``csrc/fused_attention.cuh``) serves all three and K8's layer; each
dispatcher counts only its own launches, in :data:`STATS`,
:data:`ALIGNED_STATS` and :data:`HEADED_STATS`.
"""

from __future__ import annotations

import torch

from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library, refuse_grad,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("attention_packed")                  # K2
ALIGNED_STATS = KernelStats("attention_packed_aligned")  # K9
HEADED_STATS = KernelStats("attention")                  # K10
HEAD_DIMS = (16, 32, 64, 128)  # compiled into the body (HuBERT-base: 768 / 12 = 64)
HEAD_PAD = 128                 # K9's lanes per head


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
    """softmax(q_h k_h^T * scale) v_h per head, float32 scores, packed layout."""
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
    """Launch K2 on float32 CUDA (B, T, H*D) views whose last dim is unit-stride."""
    require_cuda_f32("attention_packed", q, k, v)
    _require_same("attention_packed", q, k, v, 3, "(B, T, H*D)")
    b, t, hd = q.shape
    d = hd // num_heads
    if d * num_heads != hd or d not in HEAD_DIMS:
        raise ValueError(f"attention_packed: head dim {hd}/{num_heads} is not one of "
                         f"{HEAD_DIMS}, the ones the kernel is built for")
    out = torch.empty((b, t, hd), device=q.device, dtype=torch.float32)
    check(library().qvc_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, num_heads, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), float(scale), stream_ptr(q)), "attention_packed kernel")
    STATS.count()
    return out


def attention_packed_aligned_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    num_heads: int, scale: float,
                                    head_pad: int = HEAD_PAD) -> torch.Tensor:
    """Launch K9 on float32 CUDA (B, T, H*128) views whose last dim is unit-stride."""
    require_cuda_f32("attention_packed_aligned", q, k, v)
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
    require_cuda_f32("attention", q, k, v)
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
    """Packed MHA core (K2): plain on CPU, the kernel on CUDA. No backward."""
    refuse_grad("attention_packed", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, scale)
    return attention_packed_kernel(q, k, v, num_heads, scale)


def attention_packed_aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             num_heads: int, scale: float,
                             head_pad: int = HEAD_PAD) -> torch.Tensor:
    """Packed MHA over heads zero-padded to ``head_pad`` lanes (K9): plain on
    CPU, the kernel on CUDA. No backward."""
    refuse_grad("attention_packed_aligned", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_aligned_reference(q, k, v, num_heads, scale, head_pad)
    return attention_packed_aligned_kernel(q, k, v, num_heads, scale, head_pad)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """MHA on (B, H, T, D) (K10): plain on CPU, the kernel on CUDA. No backward."""
    refuse_grad("attention", q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    return attention_kernel(q, k, v, scale)
