"""Kernel K2: packed multi-head attention (``csrc/fused_attention.cu``) and its dispatch.

Replaces the TPU kernel ``quickvc_tpu/ops/fused_attention.py:fused_attention_packed``.
q, k and v are (B, T, H*D) as the in-projection produces them; the output
is (B, T, H*D), ready for the out-projection. A CPU tensor takes the plain
version, :func:`attention_packed_reference`; a CUDA tensor launches the
kernel or raises. The kernel's body is shared with K8's layer
(``csrc/fused_attention.cuh``); :data:`STATS` counts only launches made here.
"""

from __future__ import annotations

import torch

from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library, refuse_grad,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("attention_packed")
HEAD_DIM = 64  # compiled into the kernel (HuBERT-base: 768 / 12)


def attention_packed_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q_h k_h^T * scale) v_h per head, float32 scores, packed layout."""
    b, t, hd = q.shape
    d = hd // num_heads

    def heads(z):
        return z.reshape(b, t, num_heads, d).transpose(1, 2)

    s = (heads(q) @ heads(k).transpose(-1, -2)).float() * scale
    o = torch.softmax(s, dim=-1).to(v.dtype) @ heads(v)
    return o.transpose(1, 2).reshape(b, t, hd)


def attention_packed_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Launch K2 on float32 CUDA views whose last dim is unit-stride."""
    require_cuda_f32("attention_packed", q, k, v)
    b, t, hd = q.shape
    if (k.shape != q.shape or v.shape != q.shape or hd != num_heads * HEAD_DIM
            or any(z.stride(-1) != 1 for z in (q, k, v))):
        raise ValueError(f"attention_packed: need (B, T, {num_heads}*{HEAD_DIM}) "
                         f"q/k/v with unit column stride, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    out = torch.empty((b, t, hd), device=q.device, dtype=torch.float32)
    check(library().qvc_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, num_heads,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), float(scale), stream_ptr(q)), "attention_packed kernel")
    STATS.launches += 1
    return out


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float) -> torch.Tensor:
    """Packed MHA core: plain on CPU, K2 on CUDA. No backward."""
    refuse_grad("attention_packed", q, k, v)
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, scale)
    return attention_packed_kernel(q, k, v, num_heads, scale)
