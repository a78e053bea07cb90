"""PyTorch port, the persistent TMA + wgmma bf16 GEMM core
(``csrc/wgmma_bf16.cuh``) that K8's bf16 mode runs its four GEMMs on, on the
CPU (no JAX): its host plan and persistent schedule
(``ops/fused_transformer.py:wgmma_plan``, ``wgmma_schedule``), a numpy model
of the 128-byte swizzle that TMA writes and the wgmma descriptors read, and
of the m64nBNk16 accumulator layout through the ROUND, GELU and RESIDUAL
epilogues against the plain version's linear parts.

The model walks the kernel: work items (split, tile row, tile col) in the
schedule's order, each a 128 x BN tile over its split's 64-wide k tiles
(zeros past K, as TMA fills them), bf16 products exact and summed in
float32, each accumulator register stored where the epilogue stores it, and
a split GEMM's partials summed in split order. Every output is written once
a split.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_support import bf16_values

from quickvc_tpu_torch.ops import fused_transformer as ft
from quickvc_tpu_torch.utils import bf16

# the shapes of K8's GEMMs: (N, K) of in_proj, out_proj, linear1, linear2
GEMMS = ((2304, 768), (768, 768), (3072, 768), (768, 3072))
# M = B x T rows on the paths: the encoding batch (16, 300), one utterance,
# 16 x 250 frames, the live wave windows of 64 and 8 streams and of one
PATH_M = (4800, 300, 4000, 64 * 80, 64 * 68, 8 * 80, 80, 68)


def bf16_round(x) -> np.ndarray:
    return bf16_values(bf16.to_bits(np.asarray(x, np.float32)))


def fragment(bn: int):
    """(row, col) within a 128 x bn tile of every accumulator register:
    arrays over (consumer warpgroup, warp, lane, register)."""
    c, w, lane, i = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(bn // 2),
                                indexing="ij")
    row = 64 * c + 16 * w + lane // 4 + 8 * ((i % 4) // 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row, col


def linear_model(a: np.ndarray, w: np.ndarray, plan: ft.WgmmaPlan,
                 sm_count: int = 132) -> np.ndarray:
    """The float32 sums of A (M, K) W (N, K)^T as the core computes them
    (before the epilogue), item by item from the schedule."""
    m, k = a.shape
    n = w.shape[0]
    bn, bm, bk = plan.bn, ft.WG_TILE_M, ft.WG_K_TILE
    parts = np.full((plan.splits, m, n), np.nan, np.float32)
    row, col = fragment(bn)
    for block in ft.wgmma_schedule(m, n, plan, sm_count):
        for z, tm, tn in block:
            k0, k1 = z * plan.k_chunk, min(k, (z + 1) * plan.k_chunk)
            acc = np.zeros((bm, bn), np.float32)
            for kt in range(k0, k1, bk):
                ta, tw = np.zeros((bm, bk), np.float32), np.zeros((bn, bk), np.float32)
                ra, rw = a[tm * bm: (tm + 1) * bm, kt: min(kt + bk, k)], \
                    w[tn * bn: (tn + 1) * bn, kt: min(kt + bk, k)]
                ta[: ra.shape[0], : ra.shape[1]], tw[: rw.shape[0], : rw.shape[1]] = ra, rw
                for kk in range(0, bk, 16):   # one m64nBNk16 a step
                    d = ta[:, kk: kk + 16].astype(np.float64) @ tw[:, kk: kk + 16].T
                    acc = (acc + d).astype(np.float32)
            rows, cols = tm * bm + row, tn * bn + col
            ok = (rows < m) & (cols < n)
            assert np.isnan(parts[z, rows[ok], cols[ok]]).all()
            parts[z, rows[ok], cols[ok]] = acc[row[ok], col[ok]]
    assert not np.isnan(parts).any(), "an output no item wrote"
    total = parts[0]
    for z in range(1, plan.splits):
        total = (total + parts[z]).astype(np.float32)
    return total


@pytest.mark.parametrize("sm_count", [132, 114, 8])
def test_schedule_covers_every_item_once(sm_count):
    """Every (split, tile) of the four GEMMs at the paths' M exactly once,
    on a grid of min(SMs, items) blocks."""
    for m in PATH_M:
        for n, k in GEMMS:
            plan = ft.wgmma_plan(m, n, k, sm_count)
            blocks = ft.wgmma_schedule(m, n, plan, sm_count)
            tiles_m, tiles_n = -(-m // ft.WG_TILE_M), -(-n // plan.bn)
            items = [it for block in blocks for it in block]
            want = {(z, i, j) for z in range(plan.splits) for i in range(tiles_m)
                    for j in range(tiles_n)}
            assert len(items) == len(set(items)) and set(items) == want, (m, n, k)
            assert len(blocks) == min(sm_count, len(want))


@pytest.mark.parametrize("sm_count", [132, 114, 8])
def test_plan_takes_the_least_modelled_cost(sm_count):
    """Compiled tiles, splits on 64-wide k-tile edges covering K once, none
    empty, and no (bn, splits) the plan may take models cheaper."""
    for m in PATH_M + (37, 111, 900):
        for n, k in GEMMS:
            p = ft.wgmma_plan(m, n, k, sm_count)
            assert p.bn in ft.WG_TILE_NS and 1 <= p.splits <= ft.MAX_SPLITS
            assert p.k_chunk % ft.WG_K_TILE == 0
            assert (p.splits - 1) * p.k_chunk < k <= p.splits * p.k_chunk
            assert p.workspace == (p.splits * m * n if p.splits > 1 else 0)
            best = ft.wgmma_cost(m, n, k, p.bn, p.splits, sm_count)
            k_tiles = -(-k // ft.WG_K_TILE)
            for bn in ft.WG_TILE_NS:
                for s in range(1, ft.MAX_SPLITS + 1):
                    if s == 1 or k_tiles >= s * ft.MIN_SPLIT_K_TILES:
                        per = -(-k_tiles // s)
                        assert best <= ft.wgmma_cost(m, n, k, bn, -(-k_tiles // per),
                                                     sm_count) + 1e-15
    # the encoding batch: 256-wide tiles, unsplit; out_proj and linear2 in one wave
    plans = ft.wgmma_layer_plans(4800, 768, 3072)
    assert [(p.bn, p.splits) for p in plans] == [(256, 1)] * 4
    assert len(ft.wgmma_schedule(4800, 768, plans[1])) == 114


def test_swizzle_maps_chunks_one_to_one():
    """TMA's 128-byte swizzle puts 16-byte chunk q of row r of a stage at
    chunk q ^ (r % 8) of its 128-byte row, 1024 bytes an 8-row group: one
    to one onto the stage. A wgmma descriptor on the 1024-aligned stage,
    advanced 32 bytes a k16 step, swizzles the same address bits (4-6 by
    7-9), so it reads each (row, k) where TMA wrote it."""
    for rows in (ft.WG_TILE_M, *ft.WG_TILE_NS):
        r, q = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
        tma = (r // 8) * 1024 + (r % 8) * 128 + ((q ^ (r % 8)) << 4)
        assert sorted(tma.ravel()) == list(range(0, rows * 128, 16))
        for kk in range(4):
            for half in range(2):   # the step's k 0-7 and 8-15
                logical = r[:, 0] * 128 + 32 * kk + 16 * half
                physical = logical ^ (((logical >> 7) & 7) << 4)
                np.testing.assert_array_equal(physical, tma[:, 2 * kk + half])


@pytest.mark.parametrize("bn", ft.WG_TILE_NS)
def test_accumulator_layout_and_epilogues_match_the_plain_linear_parts(bn):
    """The fragment map covers a 128 x bn tile once; through it, the float32
    sums with the bias, then ROUND (in_proj), GELU (linear1) and RESIDUAL
    (out_proj, linear2) as ``bf16_gemm.cuh:store_pair`` computes them on a
    lane's column pair, against the plain version's linear parts
    (``transformer_layer_reference_bf16``) on the same sums: ROUND and
    RESIDUAL exact, GELU within one bf16 ulp, or 1e-6 where 1 + tanh cancels
    in its negative tail (numpy's tanh against torch's)."""
    row, col = fragment(bn)
    cover = np.zeros((128, bn), int)
    np.add.at(cover, (row, col), 1)
    assert (cover == 1).all()
    rng = np.random.default_rng(bn)
    sums = (rng.standard_normal((128, bn)) * 3).astype(np.float32)
    bias = rng.standard_normal(bn).astype(np.float32)
    res = bf16_round(rng.standard_normal((128, bn)))
    v = (sums[row, col] + bias[col]).astype(np.float32)   # each register, its bias added
    out = {k: np.full((128, bn), np.nan, np.float32) for k in ("round", "gelu", "residual")}
    out["round"][row, col] = bf16_round(v)
    g = bf16_round(v)
    out["gelu"][row, col] = bf16_round(0.5 * g * (1 + np.tanh(np.float32(0.7978845608028654)
                                                             * (g + np.float32(0.044715) * g * g * g))))
    out["residual"][row, col] = v + res[row, col]
    lin = torch.from_numpy(sums) + torch.from_numpy(bias)   # the plain linear's float32 sum
    np.testing.assert_array_equal(out["round"], lin.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(out["residual"],
                                  (torch.from_numpy(res) + lin).numpy())
    plain_gelu = F.gelu(lin.to(torch.bfloat16), approximate="tanh").float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(plain_gelu), 1e-30))) - 7)
    assert (np.abs(out["gelu"] - plain_gelu) <= np.maximum(ulp, 1e-6)).all()


@pytest.mark.parametrize("m,n,k,splits", [(300, 768, 3072, None), (150, 200, 136, 2),
                                          (37, 72, 520, None)])
def test_core_model_against_float64(m, n, k, splits):
    """The core's sums against float64 products within float32 summation
    error: linear2 at one utterance (the plan splits K three ways), a ragged
    tile with a forced 2-way split whose second range is not whole k tiles,
    and a ragged K."""
    rng = np.random.default_rng(m + k)
    a, w = bf16_round(rng.standard_normal((m, k))), bf16_round(rng.standard_normal((n, k)))
    plan = ft.wgmma_plan(m, n, k)
    if splits:
        per = -(-(-(-k // 64)) // splits)
        plan = ft.WgmmaPlan(plan.bn, splits, per * 64, splits * m * n)
    ours = linear_model(a, w, plan)
    exact = a.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(a).astype(np.float64) @ np.abs(w).astype(np.float64).T
    assert (np.abs(ours - exact) <= 1e-5 * scale).all()
