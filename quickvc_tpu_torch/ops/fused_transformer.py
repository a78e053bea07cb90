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

A bf16 x takes the layer's bf16 mode (``qvc_transformer_layer_bf16``), as
the TPU kernel computes a bf16 input: the four weight matrices cast to bf16
once a call (as the JAX wrapper casts them), the GEMMs on the persistent
TMA + ``wgmma`` bf16 core of ``csrc/wgmma_bf16.cuh`` (each planned by
:func:`wgmma_plan`), K2's bf16 attention body (planned by
``ops.fused_attention.bf16_attention_plan``), float32 biases, LayerNorms
and GELU, rounded to bf16 where the TPU kernel rounds; a bf16 output.
:data:`STATS` counts float32 calls, :data:`BF16_STATS` bf16 ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (F32_BF16, KernelStats, check, device_sms, library,
                                         on_tensor_device, refuse_grad, require_cuda,
                                         require_device, require_dtype, stream_ptr)
from quickvc_tpu_torch.ops.fused_attention import attention_reference, bf16_attention_plan

STATS = KernelStats("transformer_layer")
BF16_STATS = KernelStats("transformer_layer_bf16")
HEAD_DIM = 64   # compiled into the attention (HuBERT-base: 768 / 12)
EPS = 1e-5


# The float32 GEMMs' tiling (csrc/fused_transformer.cu: BM, BN, BK), one block
# an SM. K5's tile is the same 256 x 128 x 32 on the same 3xTF32 body, and
# took 1.318 ms for 2 waves of 160 K tiles (4.1 us a K tile, PERF.md's K5
# row): K_TILE_BYTES is the device-memory traffic the H100's 3.35 TB/s moves
# in that time, the plan's unit of cost.
TILE_M, TILE_N, K_TILE = 256, 128, 32
K_TILE_BYTES = 3.35e12 * 1.318e-3 / 320
MAX_SPLITS = 4
MIN_SPLIT_K_TILES = 4   # K tiles a split walks at least


class LinearPlan(NamedTuple):
    """How one GEMM (M, N, K) runs: split z takes the reduction range
    [z * k_chunk, min((z + 1) * k_chunk, K)); ``workspace`` floats hold the
    partials (0 for one split, which writes C directly)."""
    splits: int
    k_chunk: int
    workspace: int


def linear_plan(m: int, n: int, k: int, sm_count: int = 132) -> LinearPlan:
    """The split count that finishes the GEMM soonest by a model of its time.

    The grid is ceil(M / TILE_M) x ceil(N / TILE_N) tiles, one block an
    SM; split s ways it runs ceil(tiles s / sm_count) waves of blocks that
    walk ceil(K tiles / s) K tiles each, and its partials cost 2 s M N
    floats of device-memory traffic (written, then read by the sum), counted
    in K-tile times (``K_TILE_BYTES``). The plan takes the s in
    1..MAX_SPLITS of least time (ties to the smaller s), each split walking
    at least MIN_SPLIT_K_TILES K tiles, evened on K-tile edges so that none
    is empty. At 16 x 300 frames
    (M = 4,800) no float32 GEMM splits: the partials would cost more than
    the last wave's idle SMs; at 16 x 250 in_proj splits 2 ways and linear2
    4; a small batch fills the card only split.
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
    return tuple(linear_plan(m, n, k, sm_count)
                 for n, k in ((3 * d, d), (d, d), (f, d), (d, f)))


# The persistent TMA + wgmma bf16 core (csrc/wgmma_bf16.cuh): 128 x BN tiles,
# 64-wide k tiles, one block an SM, work items in a grouped raster of
# WG_GROUP_M tile rows.
WG_TILE_M, WG_K_TILE, WG_GROUP_M = 128, 64, 8
WG_TILE_NS = (64, 128, 192, 256)
BF16_FLOPS, HBM_BYTES = 989e12, 3.35e12   # H100 SXM data sheet
SPLIT_SUM_SECONDS = 3e-6                  # the split-K sum's launch


class WgmmaPlan(NamedTuple):
    """How one GEMM (M, N, K) runs on the wgmma core: 128 x ``bn`` tiles,
    split z taking the reduction range [z k_chunk, min((z + 1) k_chunk, K));
    ``workspace`` floats of partials (0 for one split)."""
    bn: int
    splits: int
    k_chunk: int
    workspace: int


def wgmma_cost(m: int, n: int, k: int, bn: int, splits: int, sm_count: int = 132,
               k_tile_seconds: dict[int, float] | None = None) -> float:
    """Modelled seconds of one GEMM on the wgmma core: waves of work items
    (tiles x splits over one block an SM) times an item's k tiles, each
    costing its 128 x bn x 64 products at the SM's share of the bf16 rate
    plus the A tile's (as if 64 more columns: the stage's load and handshake
    that every k tile pays whatever bn), or ``k_tile_seconds[bn]`` where a
    body's k tile was timed on the card; a split GEMM adds its partials'
    traffic (written, then read by the sum) and the sum's launch."""
    k_tiles = -(-k // WG_K_TILE)
    per = -(-k_tiles // splits)
    items = -(-m // WG_TILE_M) * -(-n // bn) * splits
    k_tile = (k_tile_seconds[bn] if k_tile_seconds else
              2 * WG_TILE_M * (bn + 64) * WG_K_TILE / (BF16_FLOPS / 132))
    split = (2 * splits * m * n * 4 / HBM_BYTES + SPLIT_SUM_SECONDS) if splits > 1 else 0.0
    return -(-items // sm_count) * per * k_tile + split


def wgmma_plan(m: int, n: int, k: int, sm_count: int = 132, max_splits: int = MAX_SPLITS,
               k_tile_seconds: dict[int, float] | None = None) -> WgmmaPlan:
    """The (bn, splits) of least :func:`wgmma_cost` (ties to fewer splits,
    then the wider tile), at most ``max_splits`` splits, each walking at
    least MIN_SPLIT_K_TILES k tiles, evened on k-tile edges so that none is
    empty. At 16 x 300 frames every GEMM takes bn 256 unsplit: out_proj and
    linear2 are one wave of 114 tiles; a small batch takes narrow tiles or
    splits."""
    k_tiles = -(-k // WG_K_TILE)

    def even(s: int) -> tuple[int, int]:   # (splits, k tiles a split)
        per = -(-k_tiles // s)
        return -(-k_tiles // per), per

    options = [(bn, *even(s)) for bn in WG_TILE_NS for s in range(1, max_splits + 1)
               if s == 1 or k_tiles >= s * MIN_SPLIT_K_TILES]
    bn, splits, per = min(options, key=lambda o: (
        wgmma_cost(m, n, k, o[0], o[1], sm_count, k_tile_seconds), o[1], -o[0]))
    return WgmmaPlan(bn, splits, per * WG_K_TILE, splits * m * n if splits > 1 else 0)


def wgmma_layer_plans(m: int, d: int, f: int, sm_count: int = 132) -> tuple[WgmmaPlan, ...]:
    """:func:`wgmma_plan` of in_proj, out_proj, linear1 and linear2, in turn."""
    return tuple(wgmma_plan(m, n, k, sm_count)
                 for n, k in ((3 * d, d), (d, d), (f, d), (d, f)))


def wgmma_schedule(m: int, n: int, plan: WgmmaPlan,
                   sm_count: int = 132) -> list[list[tuple[int, int, int]]]:
    """The work items (split, tile row, tile col) each block of the
    persistent grid takes, in order: the host twin of
    ``csrc/tma_wgmma.cuh:Schedule`` (item t goes to block t mod grid)."""
    tiles_m, tiles_n = -(-m // WG_TILE_M), -(-n // plan.bn)
    tiles = tiles_m * tiles_n
    total = tiles * plan.splits
    grid = min(sm_count, total)

    def item(t: int) -> tuple[int, int, int]:
        z, local = divmod(t, tiles)
        grp, within = divmod(local, WG_GROUP_M * tiles_n)
        first = grp * WG_GROUP_M
        rows = min(WG_GROUP_M, tiles_m - first)
        return z, first + within % rows, within // rows

    return [[item(t) for t in range(b, total, grid)] for b in range(grid)]


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
    computes it: acc = bout + sum_h softmax(q_h k_h^T / sqrt(d)) v_h Wout[:, h]^T;
    a bf16 x takes :func:`transformer_layer_reference_bf16`."""
    if x.dtype == torch.bfloat16:
        return transformer_layer_reference_bf16(x, layer)
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


def transformer_layer_reference_bf16(x: torch.Tensor, layer) -> torch.Tensor:
    """The TPU kernel at bf16 (``quickvc_tpu/ops/fused_transformer.py:63-117``):
    every product on bf16 operands (the weights rounded to bf16) summed in
    float32, the biases, LayerNorms and GELU in float32, rounded to bf16
    where it rounds: qkv, p and each head's output (:func:`attention_reference`
    at bf16), x1, the linear1 pre-activation, the GELU and the output."""
    w_in, b_in, w_out, b_out, g1, be1, w1, b1, w2, b2, g2, be2 = _weights(layer)
    b, t, d = x.shape
    h = layer.self_attn.num_heads
    bf16 = torch.bfloat16

    def linear(a, w, bias):   # bf16 operands, float32 sums and bias
        return F.linear(a.float(), w.to(bf16).float(), bias.float())

    q, k, v = (z.reshape(b, t, h, d // h).transpose(1, 2)
               for z in linear(x, w_in, b_in).to(bf16).chunk(3, dim=-1))
    heads = attention_reference(q, k, v, 1.0 / math.sqrt(d // h))
    acc = linear(heads.transpose(1, 2).reshape(b, t, d), w_out, b_out)
    x1 = _layer_norm(x.float() + acc, g1.float(), be1.float()).to(bf16)
    mid = F.gelu(linear(x1, w1, b1).to(bf16), approximate="tanh")
    return _layer_norm(x1.float() + linear(mid, w2, b2), g2.float(), be2.float()).to(bf16)


@on_tensor_device
def transformer_layer_kernel(x: torch.Tensor, layer) -> torch.Tensor:
    """Launch K8 on a float32 CUDA (B, T, H*64) tensor and the layer's float32
    weights, or its bf16 mode on a bf16 one (the weight matrices cast to bf16
    and the vectors to float32 here, once a call)."""
    weights = _weights(layer)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        require_device("transformer_layer", x, *weights)
        weights = [w.to(torch.bfloat16) if w.dim() == 2 else w.float() for w in weights]
    else:
        require_cuda("transformer_layer", x, *weights, dtypes=F32_BF16)
    weights = [w.contiguous() for w in weights]
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

    def scratch(cols, dtype=x.dtype):
        return torch.empty((m, cols), device=x.device, dtype=dtype)

    # the scratch in x's dtype; the float32 sums the LayerNorms read
    qkv, heads, x1, mid = scratch(3 * d), scratch(d), scratch(d), scratch(f)
    total = scratch(d, torch.float32)
    sms = device_sms(x.device.index or 0)
    plans = wgmma_layer_plans(m, d, f, sms) if bf16 else layer_plans(m, d, f, sms)
    ws_floats = max(p.workspace for p in plans)
    ws = torch.empty(ws_floats, device=x.device, dtype=torch.float32) if ws_floats else None
    out = torch.empty_like(x)
    entry = library().qvc_transformer_layer_bf16 if bf16 else library().qvc_transformer_layer
    # the bf16 attention reads the qkv scratch's aligned column views
    attn = bf16_attention_plan(b, h, t, HEAD_DIM, sms).c_args() if bf16 else ()
    check(entry(
        x.data_ptr(), *[w.data_ptr() for w in weights], qkv.data_ptr(), heads.data_ptr(),
        total.data_ptr(), x1.data_ptr(), mid.data_ptr(), None if ws is None else ws.data_ptr(),
        out.data_ptr(), b, t, d, h, f, 1.0 / math.sqrt(HEAD_DIM),
        *[v for p in plans for v in p[:-1]], *attn, stream_ptr(x)),
        f"transformer_layer kernel ({x.dtype})")
    (BF16_STATS if bf16 else STATS).count()
    return out


def transformer_layer(x: torch.Tensor, layer) -> torch.Tensor:
    """One post-norm layer: plain on CPU, K8 on CUDA; a float32 or bf16 x, the
    output in its dtype. No backward."""
    refuse_grad("transformer_layer", x, *_weights(layer))
    require_dtype("transformer_layer", x, dtypes=F32_BF16)
    if x.device.type == "cpu":
        return transformer_layer_reference(x, layer)
    return transformer_layer_kernel(x, layer)
