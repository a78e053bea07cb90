"""Kernel K8: one whole post-norm HuBERT transformer layer (``csrc/fused_transformer.cu``).

Replaces the TPU kernel ``quickvc_tpu/ops/fused_transformer.py:fused_transformer_layer``.
The layer is given as the port's ``models.hubert.TransformerLayer`` (its
``self_attn.in_proj_weight``/``in_proj_bias``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2`` and ``self_attn.num_heads``);
x is (B, T, D). :func:`transformer_layer` takes the plain version,
:func:`transformer_layer_reference`, for a CPU tensor and launches the
kernel for a CUDA tensor (or raises). One kernel call is the C entry point
``qvc_transformer_layer``, which makes ``qvc_transformer_layer_launches()``
launches (GEMMs, K2's attention, two LayerNorms); :data:`STATS` counts calls.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (KernelStats, check, library, refuse_grad,
                                         require_cuda_f32, stream_ptr)

STATS = KernelStats("transformer_layer")
HEAD_DIM = 64   # compiled into the attention (HuBERT-base: 768 / 12)
EPS = 1e-5


def _weights(layer) -> list[torch.Tensor]:
    a = layer.self_attn
    return [a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
            layer.norm1.weight, layer.norm1.bias, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, layer.norm2.weight, layer.norm2.bias]


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Variance about the mean (two passes), as the TPU kernel's ``_layer_norm``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * g + b


def transformer_layer_reference(x: torch.Tensor, layer) -> torch.Tensor:
    """The layer with the out-projection folded per head, as the TPU kernel
    computes it: acc = bout + sum_h softmax(q_h k_h^T / sqrt(d)) v_h Wout[:, h]^T."""
    w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2 = _weights(layer)
    b, t, d = x.shape
    h = layer.self_attn.num_heads
    hd = d // h
    q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2)
               for z in F.linear(x, w_in, b_in).chunk(3, dim=-1))
    p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    acc = torch.einsum("bhtc,ehc->bte", p @ v, w_out.reshape(d, h, hd)) + b_out
    x1 = _layer_norm(x + acc, g1, be1)
    y = F.linear(F.gelu(F.linear(x1, w1, b1)), w2, b2)
    return _layer_norm(x1 + y, g2, be2)


def transformer_layer_kernel(x: torch.Tensor, layer) -> torch.Tensor:
    """Launch K8 on a float32 CUDA (B, T, H*64) tensor and the layer's weights."""
    weights = [w.contiguous() for w in _weights(layer)]
    require_cuda_f32("transformer_layer", x, *weights)
    b, t, d = x.shape
    h = layer.self_attn.num_heads
    f = weights[6].shape[0]
    x = x.contiguous()
    if d != h * HEAD_DIM or d > 1024 or f % 8:
        raise ValueError(f"transformer_layer: need D = H*{HEAD_DIM} <= 1024 and an FFN "
                         f"width divisible by 8, got D={d}, H={h}, F={f}")
    if any(z.data_ptr() % 16 for z in [x, *weights]):
        raise ValueError("transformer_layer: every tensor must start on a 16-byte boundary")
    m = b * t

    def scratch(cols):
        return torch.empty((m, cols), device=x.device, dtype=torch.float32)

    qkv, heads, total, x1, mid = scratch(3 * d), scratch(d), scratch(d), scratch(d), scratch(f)
    out = torch.empty_like(x)
    check(library().qvc_transformer_layer(
        x.data_ptr(), *[w.data_ptr() for w in weights], qkv.data_ptr(), heads.data_ptr(),
        total.data_ptr(), x1.data_ptr(), mid.data_ptr(), out.data_ptr(), b, t, d, h, f,
        1.0 / math.sqrt(HEAD_DIM), stream_ptr(x)), "transformer_layer kernel")
    STATS.count()
    return out


def transformer_layer(x: torch.Tensor, layer) -> torch.Tensor:
    """One post-norm layer: plain on CPU, K8 on CUDA. No backward."""
    refuse_grad("transformer_layer", x, *_weights(layer))
    if x.device.type == "cpu":
        return transformer_layer_reference(x, layer)
    return transformer_layer_kernel(x, layer)
