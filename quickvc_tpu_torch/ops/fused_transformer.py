"""Kernel K8: one whole post-norm HuBERT transformer layer (``csrc/fused_transformer.cu``).

Replaces the TPU kernel ``quickvc_tpu/ops/fused_transformer.py:fused_transformer_layer``.
The layer is given as the port's ``models.hubert.TransformerLayer`` (its
``self_attn.in_proj_weight``/``in_proj_bias``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2`` and ``self_attn.num_heads``);
x is (B, T, D). :func:`transformer_layer` takes the plain version,
:func:`transformer_layer_reference`, for a CPU tensor and launches the
kernel for a CUDA tensor (or raises). One kernel call is the C entry point
``qvc_transformer_layer``, which makes ``qvc_transformer_layer_launches``
launches (four GEMMs, K2's attention, two LayerNorms, and a split-K sum for
each GEMM that :func:`linear_plan` splits); :data:`STATS` counts calls.

The four GEMMs run on TF32 tensor cores in 3xTF32. :func:`linear_plan`
picks each one's split of its reduction: partial sums of a split GEMM go to
a workspace that a second kernel sums in split order, so the same inputs
give the same bits on every launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (KernelStats, bf16_item, check, device_sms, library,
                                         refuse_grad, require_cuda, require_dtype, stream_ptr)

STATS = KernelStats("transformer_layer")
BF16_MODE = bf16_item("A20")   # the fused-layer encode at bf16
HEAD_DIM = 64   # compiled into the attention (HuBERT-base: 768 / 12)
EPS = 1e-5

# The GEMMs' tiling (csrc/fused_transformer.cu: BM, BN, BK, MAX_SPLITS): a
# block computes a TILE_M x TILE_N output tile and walks K in tiles of
# K_TILE (a split edge off them is refused), one block an SM.
TILE_M, TILE_N, K_TILE = 256, 128, 32
MAX_SPLITS = 4
MIN_SPLIT_K_TILES = 4   # K tiles a split walks at least
# Device-memory bytes the card moves in the time one block takes for one K
# tile: K5's tile is the same 256 x 128 x 32 on the same 3xTF32 body, and
# took 1.318 ms for 2 waves of 160 K tiles (4.1 us a K tile, PERF.md,
# PR 7), at the H100's 3.35 TB/s.
K_TILE_BYTES = 3.35e12 * 1.318e-3 / 320


class LinearPlan(NamedTuple):
    """How one GEMM (M, N, K) runs: split z takes the reduction range
    [z * k_chunk, min((z + 1) * k_chunk, K)); ``workspace`` floats hold the
    partials (0 for one split, which writes C directly)."""
    splits: int
    k_chunk: int
    workspace: int


def linear_plan(m: int, n: int, k: int, sm_count: int = 132) -> LinearPlan:
    """The split count that finishes the GEMM soonest by a model of its time.

    The grid is ceil(M / TILE_M) x ceil(N / TILE_N) tiles, one block an SM;
    split s ways it runs ceil(tiles s / sm_count) waves of blocks that walk
    ceil(K tiles / s) K tiles each, and its partials cost 2 s M N floats of
    device-memory traffic (written, then read by the sum), counted in K-tile
    times (K_TILE_BYTES). The plan takes the s in 1..MAX_SPLITS of least
    time (ties to the smaller s), each split walking at least
    MIN_SPLIT_K_TILES K tiles, evened on K-tile edges so that none is empty.
    At 16 x 300 frames (M = 4,800) no GEMM splits: the partials would cost
    more than the last wave's idle SMs; at 16 x 250 in_proj splits 2 ways
    and linear2 4; a small batch fills the card only split.
    """
    k_tiles = -(-k // K_TILE)
    tiles = -(-m // TILE_M) * -(-n // TILE_N)

    def even(s: int) -> tuple[int, int]:   # (splits, K tiles a split)
        per = -(-k_tiles // s)
        return -(-k_tiles // per), per

    def cost(s: int) -> float:
        s, per = even(s)
        traffic = 2 * s * m * n * 4 / K_TILE_BYTES if s > 1 else 0.0
        return -(-tiles * s // sm_count) * per + traffic

    allowed = [s for s in range(1, MAX_SPLITS + 1) if s == 1 or k_tiles >= s * MIN_SPLIT_K_TILES]
    splits, per = even(min(allowed, key=lambda s: (cost(s), s)))
    return LinearPlan(splits, per * K_TILE, splits * m * n if splits > 1 else 0)


def layer_plans(m: int, d: int, f: int, sm_count: int = 132) -> tuple[LinearPlan, ...]:
    """The plans of in_proj (N 3D, K D), out_proj (D, D), linear1 (F, D) and
    linear2 (D, F) at M = B*T rows, in the order the layer runs them."""
    return tuple(linear_plan(m, n, k, sm_count) for n, k in ((3 * d, d), (d, d), (f, d), (d, f)))


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
    require_cuda("transformer_layer", x, *weights, why=BF16_MODE)
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
    plans = layer_plans(m, d, f, device_sms(x.device.index or 0))
    ws_floats = max(p.workspace for p in plans)
    ws = torch.empty(ws_floats, device=x.device, dtype=torch.float32) if ws_floats else None
    out = torch.empty_like(x)
    check(library().qvc_transformer_layer(
        x.data_ptr(), *[w.data_ptr() for w in weights], qkv.data_ptr(), heads.data_ptr(),
        total.data_ptr(), x1.data_ptr(), mid.data_ptr(), None if ws is None else ws.data_ptr(),
        out.data_ptr(), b, t, d, h, f, 1.0 / math.sqrt(HEAD_DIM),
        *[v for p in plans for v in (p.splits, p.k_chunk)], stream_ptr(x)),
        "transformer_layer kernel")
    STATS.count()
    return out


def transformer_layer(x: torch.Tensor, layer) -> torch.Tensor:
    """One post-norm layer: plain on CPU, K8 on CUDA. No backward."""
    refuse_grad("transformer_layer", x, *_weights(layer))
    require_dtype("transformer_layer", x, why=BF16_MODE)
    if x.device.type == "cpu":
        return transformer_layer_reference(x, layer)
    return transformer_layer_kernel(x, layer)
