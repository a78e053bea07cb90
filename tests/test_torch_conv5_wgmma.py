"""PyTorch port, the TMA + wgmma body of K5/K6's bf16 mode
(``csrc/conv5_wgmma.cu`` on the ring of ``csrc/wgmma_bf16.cuh``), on the
CPU (no JAX): its host plan and persistent schedule
(``ops/fused_disc_conv.py:conv5_wgmma_plan``, ``fused_transformer.
wgmma_schedule``), a numpy model of its shifted TMA boxes with the edge rows
the fix-up warp zeroes, of the swizzled stages the wgmma descriptors read
(K5's A K-major, K6's A and both B operands MN-major), of the m64nBNk16
accumulator layout through K5's bias + LeakyReLU epilogue and K6's rounding,
and of K6's split partials summed in split order, against the plain
versions; the host router, through a fake library.

The model follows the kernel: work items (split, tile row, tile col) in the
schedule's order; each k tile's A stage two 64 x 64 boxes of x at the rows
and channels ``Conv5Op::boxes`` gives (zeros outside x, as TMA fills them),
written into 128-byte rows with TMA's 128-byte swizzle, then each row whose
shifted x row crosses an item edge zeroed whole (``Conv5Op::fix``); B's
stage BN / 64 boxes of the filter or dym; each warpgroup's 64 x 16 A and
16 x BN B read back through the descriptors' addressing, one m64nBNk16 a
step (bf16 products exact, float32 sums); the accumulators stored where the
epilogue stores them, each output once a split. Tolerance against the plain
versions: one bf16 ulp of each element (the sums' order differs, so a
rounding may flip); the epilogue on the same float32 sums: exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_bf16_gemm import _fake, _read
from test_torch_wgmma_bf16 import bf16_round, fragment
from torch_port_support import bf16_values

from quickvc_tpu_torch.ops import fused_disc_conv as fdc
from quickvc_tpu_torch.ops import fused_transformer as ft

BM, BK = ft.WG_TILE_M, ft.WG_K_TILE
PERIODS = {p: (n, rows, c, c) for p, (n, rows, c) in fdc.disc_conv5_shapes(64, 10240).items()}
# small shapes for the whole-body model: R = 1, 2, 3, 5 (a row's two shifts
# both cross an edge), C_in 64 (K6's last tile half past 5 C_in) and 192
# (K6's second box in the next tap), ragged C_out, several K5 tiles
SMALL = [(9, 1, 64, 40), (7, 2, 128, 72), (5, 3, 64, 136), (4, 5, 192, 64), (40, 7, 64, 24)]


def boxes(dw: bool, tile_row, k, c_in: int):
    """``Conv5Op::boxes``: each box's first row index, tap and first channel
    (elementwise over arrays of tile rows and k)."""
    tile_row, k = np.asarray(tile_row), np.asarray(k)
    if dw:
        dr0, c0 = np.divmod(tile_row * BM, c_in)
        nxt = c0 + 64 == c_in
        return (k, k), (dr0, dr0 + nxt), (c0, np.where(nxt, 0, c0 + 64))
    dr, c = np.divmod(k, c_in)
    return (tile_row * BM, tile_row * BM + 64), (dr, dr), (c, c)


def tma_box(a: np.ndarray, row0: int, col0: int) -> np.ndarray:
    """A 64 x 64 box of the 2-D array a at (row0, col0): zeros outside it."""
    box = np.zeros((64, 64), a.dtype)
    rr, cc = np.arange(row0, row0 + 64), np.arange(col0, col0 + 64)
    ok_r, ok_c = (rr >= 0) & (rr < a.shape[0]), (cc >= 0) & (cc < a.shape[1])
    box[np.ix_(ok_r, ok_c)] = a[np.ix_(rr[ok_r], cc[ok_c])]
    return box


# TMA's 128-byte swizzle on a 1024-aligned box of 128-byte rows: 16-byte
# chunk q (8 values) of row i lies at chunk q ^ (i % 8) of that row
_ROW, _CHUNK = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
_PHYS = _CHUNK ^ (_ROW % 8)


def swizzle_write(box: np.ndarray) -> np.ndarray:
    """The box as TMA lays it in shared memory."""
    phys = np.empty((64, 8, 8), box.dtype)
    phys[_ROW, _PHYS] = box.reshape(64, 8, 8)[_ROW, _CHUNK]
    return phys.reshape(64, 64)


def swizzle_read(phys: np.ndarray) -> np.ndarray:
    """What a descriptor on the box reads at each logical (row, value): the
    swizzle's address bits (4-6 by 7-9) undone."""
    return phys.reshape(64, 8, 8)[_ROW, _PHYS].reshape(64, 64)


def edge_rows(first, dr, rows: int) -> np.ndarray:
    """``Conv5Op::fix``: which of a box's 64 rows (last axis) it zeroes, the
    rows whose shifted x row crosses an item edge."""
    r = (np.asarray(first)[..., None] + np.arange(64)) % rows + np.asarray(dr)[..., None] - 2
    return (r < 0) | (r >= rows)


def stage_a(x2d: np.ndarray, dw: bool, tile_row: int, k: int, rows: int) -> np.ndarray:
    """A's stage after the fix-up warp, as two (64, 64) boxes in shared
    memory's swizzled order."""
    firsts, drs, cs = boxes(dw, tile_row, k, x2d.shape[1])
    out = []
    for first, dr, c in zip(firsts, drs, cs):
        phys = swizzle_write(tma_box(x2d, int(first + dr - 2), int(c)))
        phys[edge_rows(first, dr, rows)] = 0   # a whole 128-byte row, whatever the swizzle
        out.append(phys)
    return np.stack(out)


def conv5_model(x: np.ndarray, b: np.ndarray, dw: bool, plan: ft.WgmmaPlan,
                sm_count: int = 132, parts: bool = False) -> np.ndarray:
    """The float32 sums of K5's (dw False: x (N, R, C_in) and the filter b
    (5, C_in, C_out)) or K6's (dw True: b = dym (N, R, C_out)) implicit GEMM
    as the body computes them, item by item from the schedule; split
    partials summed in split order (``parts``: the partials themselves)."""
    n, rows, c_in = x.shape
    c_out = b.shape[-1]
    x2d, b2d = x.reshape(-1, c_in), b.reshape(-1, c_out)
    m, nn, k = fdc.conv5_gemm(dw, n, rows, c_in, c_out)
    bn = plan.bn
    out = np.full((plan.splits, m, nn), np.nan, np.float32)
    row, col = fragment(bn)
    for block in ft.wgmma_schedule(m, nn, plan, sm_count):
        for z, tm, tn in block:
            k0, k1 = z * plan.k_chunk, min(k, (z + 1) * plan.k_chunk)
            acc = np.zeros((BM, bn), np.float32)
            for kt in range(k0, k1, BK):
                sa = stage_a(x2d, dw, tm, kt, rows)
                sb = [swizzle_read(swizzle_write(tma_box(b2d, kt, tn * bn + 64 * j)))
                      for j in range(bn // 64)]
                bt = np.concatenate(sb, axis=1)                    # (64 k, bn), MN-major
                for c in range(2):                                 # consumer warpgroups
                    a = swizzle_read(sa[c])
                    a = a.T if dw else a                           # -> (64 m, 64 k)
                    for kk in range(0, BK, 16):                    # one m64nBNk16 a step
                        d = a[:, kk: kk + 16].astype(np.float64) @ bt[kk: kk + 16]
                        acc[64 * c: 64 * c + 64] = (acc[64 * c: 64 * c + 64] + d).astype(
                            np.float32)
            rows_o, cols_o = tm * BM + row, tn * bn + col
            ok = (rows_o < m) & (cols_o < nn)
            assert np.isnan(out[z, rows_o[ok], cols_o[ok]]).all()
            out[z, rows_o[ok], cols_o[ok]] = acc[row[ok], col[ok]]
    assert not np.isnan(out).any(), "an output no item wrote"
    return out if parts else split_sum(out)


def split_sum(parts: np.ndarray) -> np.ndarray:
    """``splitk_sum_bf16_kernel`` before its rounding: s = ws[0], then + ws[z]
    for z = 1 .. s-1, in float32."""
    total = parts[0]
    for z in range(1, parts.shape[0]):
        total = (total + parts[z]).astype(np.float32)
    return total


def k5_epilogue(sums: np.ndarray, bias: np.ndarray | None, slope: float) -> np.ndarray:
    """K5's epilogue on float32 sums: + float(b), LeakyReLU, one rounding."""
    v = sums if bias is None else (sums + bias).astype(np.float32)
    return bf16_round(np.where(v > 0, v, np.float32(slope) * v))


def _bf16(rng: np.random.Generator, shape, scale: float = 1.0) -> np.ndarray:
    return bf16_round(scale * rng.standard_normal(shape))


def _within_one_ulp(ours: np.ndarray, plain: torch.Tensor) -> None:
    p = plain.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(p), 1e-30))) - 7)
    assert (np.abs(ours - p) <= ulp).all(), float(np.abs(ours - p).max())


@pytest.mark.parametrize("sm_count", [132, 114, 8])
def test_plan_covers_every_tile_and_k_range_once(sm_count):
    """At the five period shapes, K5's and K6's work items cover every
    (split, tile) once on a grid of min(SMs, items) blocks, the splits cover
    the reduction once on 64-wide k tiles, none empty, K5 unsplit; no
    (bn, splits) the plan may take models cheaper, each k tile at its time
    on the card. On 132 SMs K5 takes bn 256 unsplit, K6 bn 256 split 3 ways."""
    for p, (n, rows, c_in, c_out) in PERIODS.items():
        for dw in (False, True):
            m, nn, k = fdc.conv5_gemm(dw, n, rows, c_in, c_out)
            plan = fdc.conv5_wgmma_plan(dw, n, rows, c_in, c_out, sm_count)
            assert plan.bn in ft.WG_TILE_NS and plan.k_chunk % BK == 0
            assert plan.splits == 1 or dw
            cover = np.zeros(k, int)
            for z in range(plan.splits):
                lo, hi = z * plan.k_chunk, min(k, (z + 1) * plan.k_chunk)
                assert lo < hi
                cover[lo:hi] += 1
            assert (cover == 1).all()
            assert plan.workspace == (plan.splits * m * nn if plan.splits > 1 else 0)
            blocks = ft.wgmma_schedule(m, nn, plan, sm_count)
            items = [it for block in blocks for it in block]
            want = {(z, i, j) for z in range(plan.splits) for i in range(-(-m // BM))
                    for j in range(-(-nn // plan.bn))}
            assert len(items) == len(set(items)) and set(items) == want
            assert len(blocks) == min(sm_count, len(want))
            costs = fdc.CONV5_K_TILE_SECONDS
            best = ft.wgmma_cost(m, nn, k, plan.bn, plan.splits, sm_count, costs)
            k_tiles = -(-k // BK)
            for bn in ft.WG_TILE_NS:
                for s in range(1, (ft.MAX_SPLITS if dw else 1) + 1):
                    if s == 1 or k_tiles >= s * ft.MIN_SPLIT_K_TILES:
                        per = -(-k_tiles // s)
                        assert best <= ft.wgmma_cost(m, nn, k, bn, -(-k_tiles // per),
                                                     sm_count, costs) + 1e-15
            if sm_count == 132:
                assert (plan.bn, plan.splits) == ((256, 3) if dw else (256, 1)), p


@pytest.mark.parametrize("shape", list(PERIODS.values()) + [(7, 1, 64, 8), (9, 2, 64, 8),
                                                            (11, 3, 128, 8), (6, 5, 192, 8)])
def test_shifted_boxes_are_the_implicit_gemm_rows(shape):
    """Every k tile of every tile row, K5 and K6: the rows of the two boxes
    TMA loads, with the rows the fix-up warp zeroes, are A's rows of the
    implicit GEMM, A[(n, r), (dr, c)] = x[n, r + dr - 2, c] (K5) and
    A[(dr, c), (n, r)] the same (K6), zero where r + dr - 2 leaves [0, R);
    each box's 64 channels are A's k (K5) or m (K6) columns, in one tap. At
    the period shapes and at R = 1, 2, 3 and 5 (both of a row's shifts
    crossing an edge). Rows past K5's M or K6's K are left out: the epilogue
    drops the first, zero rows of dym meet the second."""
    n, rows, c_in, _ = shape
    nr = n * rows
    for dw in (False, True):
        m_len, k_len = (5 * c_in, nr) if dw else (nr, 5 * c_in)
        tm = np.arange(-(-m_len // BM))[:, None]
        kt = np.arange(0, k_len, BK)[None, :]
        firsts, drs, cs = boxes(dw, tm, kt, c_in)
        for j in range(2):
            first, dr, c = (np.broadcast_to(v, (tm.size, kt.size)) for v in
                            (firsts[j], drs[j], cs[j]))
            idx = first[..., None] + np.arange(64)        # m (K5) or k (K6) of each row
            src = idx + dr[..., None] - 2                  # the x row TMA reads
            kept = (src >= 0) & (src < nr) & ~edge_rows(first, dr, rows)
            r = idx % rows                                 # the implicit GEMM's (n, r)
            shifted = r + dr[..., None] - 2
            want = (shifted >= 0) & (shifted < rows)
            live = idx < (k_len if dw else m_len)
            np.testing.assert_array_equal(kept[live], want[live])
            np.testing.assert_array_equal(src[live & want], ((idx // rows) * rows + shifted)[
                live & want])
            col = dr * c_in + c                            # A's first k (K5) or m (K6)
            np.testing.assert_array_equal(col, np.broadcast_to(
                tm * BM + 64 * j if dw else kt, col.shape))
            assert (c % 64 == 0).all() and (c + 64 <= c_in).all()


@pytest.mark.parametrize("shape", SMALL)
def test_body_model_matches_the_plain_versions(shape):
    """The whole body (schedule, shifted and fixed boxes, swizzle, the
    descriptors' reads, m64nBNk16 steps, fragments, epilogues) on K5 (y with
    bias and LeakyReLU 0.1; dx on the flipped filter, no bias, slope 1) and
    K6 (dW), within one bf16 ulp of the plain versions on the same bf16
    inputs, each on the plan's tile; K6 also split 2 ways."""
    n, rows, c_in, c_out = shape
    rng = np.random.default_rng(c_in + 7 * rows)
    x = _bf16(rng, (n, rows, c_in))
    k = _bf16(rng, (5, c_in, c_out), (5 * c_in) ** -0.5)
    b = _bf16(rng, (c_out,), 0.1)
    dym = _bf16(rng, (n, rows, c_out), (n * rows) ** -0.5)
    tx, tk, tb, tdym = (torch.from_numpy(z).bfloat16() for z in (x, k, b, dym))

    plan5 = fdc.conv5_wgmma_plan(False, n, rows, c_in, c_out)
    y = k5_epilogue(conv5_model(x, k, False, plan5), b, 0.1)
    _within_one_ulp(y.reshape(n, rows, c_out), fdc.conv5_lrelu_reference_bf16(tx, tk, tb, 0.1))
    if c_out % 64 == 0:   # dx on this body: its C_in is C_out
        k_flip = k[::-1].transpose(0, 2, 1).copy()
        plan_dx = fdc.conv5_wgmma_plan(False, n, rows, c_out, c_in)
        dx = k5_epilogue(conv5_model(dym, k_flip, False, plan_dx), None, 1.0)
        _within_one_ulp(dx.reshape(n, rows, c_in), fdc.conv5_lrelu_reference_bf16(
            tdym, torch.from_numpy(k_flip).bfloat16(), None, 1.0))
    plan6 = fdc.conv5_wgmma_plan(True, n, rows, c_in, c_out)
    plain_dw = fdc.conv5_dw_reference(tx, tdym)
    _within_one_ulp(bf16_round(conv5_model(x, dym, True, plan6)).reshape(5, c_in, c_out),
                    plain_dw)
    k_tiles = -(-n * rows // BK)
    if k_tiles >= 2:
        per = -(-k_tiles // 2)
        split = ft.WgmmaPlan(plan6.bn, -(-k_tiles // per), per * BK, 0)
        _within_one_ulp(bf16_round(conv5_model(x, dym, True, split)).reshape(5, c_in, c_out),
                        plain_dw)


@pytest.mark.parametrize("bn", ft.WG_TILE_NS)
def test_accumulator_layout_and_epilogues_match_the_plain_versions(bn):
    """The fragment map covers a 128 x bn tile once; through it, each
    register's float32 sum with K5's epilogue (+ float(bias) from the bf16
    bias, LeakyReLU at 0.1, one rounding; dx: no bias, slope 1) and K6's
    (one rounding) as ``Conv5Op::store`` computes them on a lane's column
    pair equals the plain versions' epilogue on the same sums, exactly."""
    row, col = fragment(bn)
    cover = np.zeros((BM, bn), int)
    np.add.at(cover, (row, col), 1)
    assert (cover == 1).all()
    rng = np.random.default_rng(bn)
    sums = (rng.standard_normal((BM, bn)) * 3).astype(np.float32)
    bias = bf16_round(0.5 * rng.standard_normal(bn))
    out = {key: np.full((BM, bn), np.nan, np.float32) for key in ("y", "dx", "dw")}
    v = sums[row, col]                                   # each register's sum
    out["y"][row, col] = k5_epilogue(v, bias[col], 0.1)
    out["dx"][row, col] = k5_epilogue(v, None, 1.0)
    out["dw"][row, col] = bf16_round(v)
    s, tb = torch.from_numpy(sums), torch.from_numpy(bias).bfloat16()
    lin = s + tb.float()                                 # conv5_lrelu_reference's sum + bias
    plain_y = torch.where(lin > 0, lin, 0.1 * lin).bfloat16().float().numpy()
    np.testing.assert_array_equal(out["y"], plain_y)
    np.testing.assert_array_equal(out["dx"], s.bfloat16().float().numpy())
    np.testing.assert_array_equal(out["dw"], s.bfloat16().float().numpy())


def test_split_partials_sum_in_split_order():
    """K6 split 3 ways at (40, 7, 64, 24) (5 k tiles: 2, 2, 1): each
    split's float32 partial is the implicit GEMM over its k range within
    float32 summation error; their sum in split order 0, 1, 2, rounded once,
    is the plain version within one bf16 ulp, and differs from the sum in
    the order 2, 1, 0 somewhere (the order is the kernel's, not free)."""
    n, rows, c_in, c_out = 40, 7, 64, 24
    rng = np.random.default_rng(3)
    x = _bf16(rng, (n, rows, c_in))
    dym = _bf16(rng, (n, rows, c_out), 0.3)
    plan = ft.WgmmaPlan(64, 3, 2 * BK, 0)
    parts = conv5_model(x, dym, True, plan, parts=True)
    xp = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (0, 0)))
    a = np.concatenate([xp[:, dr: dr + rows].reshape(-1, c_in).T for dr in range(5)])
    d = dym.reshape(-1, c_out).astype(np.float64)
    for z in range(3):
        lo, hi = z * plan.k_chunk, min(n * rows, (z + 1) * plan.k_chunk)
        exact, scale = a[:, lo:hi] @ d[lo:hi], np.abs(a[:, lo:hi]) @ np.abs(d[lo:hi])
        assert (np.abs(parts[z] - exact) <= 1e-5 * scale).all()
    ordered = split_sum(parts)
    assert not np.array_equal(ordered, split_sum(parts[::-1]))
    _within_one_ulp(bf16_round(ordered).reshape(5, c_in, c_out),
                    fdc.conv5_dw_reference(torch.from_numpy(x).bfloat16(),
                                           torch.from_numpy(dym).bfloat16()))


def _offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape,offset", [(s, False) for s in PERIODS.values()]
                         + [((5, 13, 30, 42), False), ((4, 12, 33, 17), False),
                            ((6, 64, 256, 128), True), ((45, 3, 64, 1024), False)])
def test_router_sends_each_shape_to_its_body(monkeypatch, shape, offset):
    """The host picks the body by shape before the launch: the period shapes
    reach ``qvc_conv5_lrelu_bf16_wgmma`` / ``qvc_conv5_dw_bf16_wgmma`` with
    the plan's bn (and K6's split), counted in the wgmma counters and the
    bf16 ones; channels off multiples of 8 and x off a 16-byte boundary
    reach the mma.sync entries, counted in the bf16 counters only; dx goes
    where its own shape sends it."""
    n, rows, c_in, c_out = shape

    def grab_conv(x, w, bias, y, *dims):
        return dims, _read(bias, c_out, ctypes.c_uint16) if bias else None

    def grab_dw(x, dym, dw, ws, *dims):
        return dims, ws

    calls = _fake(monkeypatch, fdc, {
        "qvc_conv5_lrelu_bf16_wgmma": grab_conv, "qvc_conv5_lrelu_bf16": grab_conv,
        "qvc_conv5_dw_bf16_wgmma": grab_dw, "qvc_conv5_dw_bf16": grab_dw,
        "qvc_conv5_lrelu": grab_conv, "qvc_conv5_dw": grab_dw})
    bf = torch.bfloat16
    x = torch.zeros(n, rows, c_in, dtype=bf)
    if offset:
        x = _offset(x)
    k = torch.zeros(5, c_in, c_out, dtype=bf)
    k_flip = torch.zeros(5, c_out, c_in, dtype=bf)
    b = torch.full((c_out,), 0.3, dtype=bf)
    dym = torch.zeros(n, rows, c_out, dtype=bf)
    stats = (fdc.BF16_STATS, fdc.DW_BF16_STATS, fdc.WGMMA_STATS, fdc.DW_WGMMA_STATS,
             fdc.STATS, fdc.DW_STATS)
    before = [s.launches for s in stats]
    fdc.conv5_lrelu_kernel(x, k, b, 0.1)
    fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0)
    fdc.conv5_dw_kernel(x, dym)
    wg = (not offset and c_in % 64 == 0 and c_out % 8 == 0,
          c_out % 64 == 0 and c_in % 8 == 0,
          not offset and c_in % 64 == 0 and c_out % 8 == 0)
    if shape in PERIODS.values():
        assert wg == (True, True, True)
    (fwd, (fdims, bias)), (dx, (xdims, _)), (dwn, (wdims, ws)) = [(c[0], c[2]) for c in calls]
    assert fwd == "qvc_conv5_lrelu_bf16" + "_wgmma" * wg[0]
    assert dx == "qvc_conv5_lrelu_bf16" + "_wgmma" * wg[1]
    assert dwn == "qvc_conv5_dw_bf16" + "_wgmma" * wg[2]
    np.testing.assert_array_equal(bf16_values(bias), bf16_round(np.full(c_out, 0.3)))
    assert fdims[:5] == (n, rows, c_in, c_out, pytest.approx(0.1))
    if wg[0]:
        assert fdims[5] == fdc.conv5_wgmma_plan(False, n, rows, c_in, c_out).bn
    if wg[2]:
        plan = fdc.conv5_wgmma_plan(True, n, rows, c_in, c_out)
        assert wdims[:-1] == (n, rows, c_in, c_out, plan.bn, plan.splits, plan.k_chunk)
    else:
        plan = fdc.dw_plan(n, rows, c_in, c_out, 132, fdc.BF16_TILING)
        assert wdims[:-1] == (n, rows, c_in, c_out, plan.splits, plan.k_chunk)
    assert (ws is None) == (plan.workspace == 0)
    assert [s.launches - b0 for s, b0 in zip(stats, before)] == [
        2, 1, wg[0] + wg[1], wg[2], 0, 0]
