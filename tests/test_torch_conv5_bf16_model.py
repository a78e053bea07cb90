"""PyTorch port, the bf16 mode of K5 (k=5 conv + bias + LeakyReLU, and its dx)
and K6 (its dW), ``csrc/fused_disc_conv.cu:conv5_bf16``, on the CPU (no
JAX): a numpy model of the kernel's staging, fragments and K walk against
float64 products and the plain versions; ``dw_plan`` on the bf16 tiling;
the wrappers handing bf16 tensors to the bf16 entries.

The model follows the kernel: each K tile of A and B staged in shared
memory as the loader stages it (K5's A as [m][k] rows of 72 values, K6's A
and both B operands as they lie, [k][m] or [k][n] rows of 136; a row whose
shifted x row falls outside [0, R), or anything past M, N or the block's K
range, zero; the rows' padding NaN, so that a fragment reading it would
show), each fragment read by ``ldmatrix.x4`` (K5's A) or ``ldmatrix.x4.trans``
(every other operand) from the address each lane gives, one
``mma.sync.m16n8k16`` a tile (bf16 products exact, float32 sums), the
accumulators stored where the epilogue stores them, each output written
once a split; K6's float32 partials summed in split order and rounded to
bf16 once, K5's sums taking the bias and LeakyReLU in float32 and one
rounding. Tolerances: the sums within float32 summation error of the
float64 product (1e-5 sum |a||b|), the bf16 outputs within one bf16 ulp of
each plain-version element (the sums' order differs, so a rounding may
flip).
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_bf16_gemm import G, LANES, T4, _fake, _read, bf16_round, ldmatrix_x4, mma
from torch_port_support import bf16_values

from quickvc_tpu_torch.ops import fused_disc_conv as fdc
from quickvc_tpu_torch.ops.fused_disc_conv import BF16_TILING

# csrc/fused_disc_conv.cu, namespace conv5_bf16 (the bf16 core's tiling)
BM, BN, BK, WM, WN, LDMK, LDKN = 128, 128, 64, 64, 64, 72, 136
MT, NT = WM // 16, WN // 8


def stage_a(x: np.ndarray, conv: bool, m0: int, k0: int, k_end: int) -> np.ndarray:
    """One K tile of A as the loader stages it, flat. conv (K5): As[m][k],
    A[(n, r), (dr, c)] = x[n, r + dr - 2, c]; else (K6): As[k][m],
    A[(dr, c), (n, r)] = x[n, r + dr - 2, c]."""
    n, rows, c = x.shape
    flat = x.reshape(-1)
    if conv:
        m, k = np.meshgrid(m0 + np.arange(BM), k0 + np.arange(BK), indexing="ij")
        r, (dr, cc), limit_m = m % rows, np.divmod(k, c), n * rows
        src = (m + dr - 2) * c + cc
        shape, pitch = (BM, BK), LDMK
    else:
        k, m = np.meshgrid(k0 + np.arange(BK), m0 + np.arange(BM), indexing="ij")
        r, (dr, cc), limit_m = k % rows, np.divmod(m, c), 5 * c
        src = (k + dr - 2) * c + cc
        shape, pitch = (BK, BM), LDKN
    ok = (m < limit_m) & (k < k_end) & (r + dr - 2 >= 0) & (r + dr - 2 < rows)
    s = np.full((shape[0], pitch), np.nan, np.float32)
    s[:, :shape[1]] = np.where(ok, flat[np.where(ok, src, 0)], 0)
    return s.reshape(-1)


def stage_b(b: np.ndarray, n0: int, k0: int, k_end: int) -> np.ndarray:
    """One K tile of B (K rows x Nc) as Bs[k][n], flat."""
    kk, nn = np.meshgrid(k0 + np.arange(BK), n0 + np.arange(BN), indexing="ij")
    ok = (kk < k_end) & (nn < b.shape[1])
    s = np.full((BK, LDKN), np.nan, np.float32)
    s[:, :BN] = np.where(ok, b[np.where(ok, kk, 0), np.where(ok, nn, 0)], 0)
    return s.reshape(-1)


def gemm_model(x: np.ndarray, b: np.ndarray, conv: bool, splits: int,
               k_chunk: int) -> np.ndarray:
    """conv5_bf16_kernel's float32 sums of A @ B (M x Nc), split z over [z
    k_chunk, (z + 1) k_chunk), then the partials summed in split order."""
    n, rows, c = x.shape
    m_all, k_all = (n * rows, 5 * c) if conv else (5 * c, n * rows)
    nc = b.shape[1]
    parts = np.full((splits, m_all, nc), np.nan, np.float32)
    # the lanes' ldmatrix row addresses (values from a stage's start)
    a_conv = (LANES & 15) * LDMK + 8 * (LANES >> 4)
    a_dw = (8 * (LANES >> 4) + (LANES & 7)) * LDKN + 8 * ((LANES >> 3) & 1)
    b_lane = (8 * ((LANES >> 3) & 1) + (LANES & 7)) * LDKN + 8 * (LANES >> 4)
    for z in range(splits):
        k_begin, k_end = z * k_chunk, min(k_all, (z + 1) * k_chunk)
        for m0 in range(0, m_all, BM):
            for n0 in range(0, nc, BN):
                acc = np.zeros((4, MT, NT, 32, 4), np.float32)
                for k0 in range(k_begin, k_end, BK):
                    As, Bs = stage_a(x, conv, m0, k0, k_end), stage_b(b, n0, k0, k_end)
                    for warp in range(4):
                        wm0, wn0 = (warp // 2) * WM, (warp % 2) * WN
                        for kk in range(0, BK, 16):
                            af = [ldmatrix_x4(As, a_conv + (wm0 + 16 * i) * LDMK + kk) if conv
                                  else ldmatrix_x4(As, a_dw + kk * LDKN + wm0 + 16 * i, True)
                                  for i in range(MT)]
                            for jp in range(NT // 2):
                                bf = ldmatrix_x4(Bs, b_lane + kk * LDKN + wn0 + 16 * jp, True)
                                for i in range(MT):
                                    mma(acc[warp, i, 2 * jp], af[i], bf[:, 0], bf[:, 1])
                                    mma(acc[warp, i, 2 * jp + 1], af[i], bf[:, 2], bf[:, 3])
                for warp in range(4):   # the epilogue: column pairs of rows g, g + 8
                    wm0, wn0 = (warp // 2) * WM, (warp % 2) * WN
                    for j in range(NT):
                        col = n0 + wn0 + 8 * j + 2 * T4
                        for i in range(MT):
                            for h in range(2):
                                row = m0 + wm0 + 16 * i + G + 8 * h
                                for e in range(2):
                                    ok = (col + e < nc) & (row < m_all)
                                    assert np.isnan(parts[z, row[ok], col[ok] + e]).all()
                                    parts[z, row[ok], col[ok] + e] = acc[warp, i, j, ok, 2 * h + e]
    assert not np.isnan(parts).any(), "an output no block wrote"
    total = parts[0]
    for p in parts[1:]:
        total = (total + p).astype(np.float32)
    return total


def gather(x: np.ndarray) -> np.ndarray:
    """K5's A in float64, (N*R, 5*C_in), zero outside [0, R)."""
    n, rows, c = x.shape
    xp = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (0, 0)))
    return np.concatenate([xp[:, dr:dr + rows] for dr in range(5)], -1).reshape(n * rows, 5 * c)


def inputs(seed: int, n: int, rows: int, c_in: int, c_out: int):
    rng = np.random.default_rng(seed)
    x = bf16_round(rng.standard_normal((n, rows, c_in)))
    w = bf16_round(rng.standard_normal((5, c_in, c_out)) / np.sqrt(5 * c_in))
    b = bf16_round(0.1 * rng.standard_normal(c_out))
    dym = bf16_round(rng.standard_normal((n, rows, c_out)))
    return x, w, b, dym


def within_one_ulp(ours: np.ndarray, plain: np.ndarray) -> bool:
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(plain), 1e-30))) - 7)
    return bool((np.abs(ours - plain) <= ulp).all())


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


@pytest.mark.parametrize("shape", [(3, 37, 24, 40), (4, 12, 16, 136)])
def test_k5_bf16_model_against_float64_and_plain(shape):
    """Forward (bias, slope 0.1) and dx (the flipped, transposed filter,
    slope 1). (3, 37, 24, 40): 111 rows, a ragged K (120 of a 128-wide k
    tile pair); (4, 12, 16, 136): the shortest period's 12 rows, where the
    SAME padding and item edges are a third of them, and C_out past one
    128-wide tile."""
    n, rows, c_in, c_out = shape
    x, w, b, dym = inputs(c_in, *shape)
    for xx, ww, bb, slope in ((x, w, b, 0.1),
                              (dym, np.ascontiguousarray(w[::-1].transpose(0, 2, 1)), None, 1.0)):
        c = xx.shape[2]
        sums = gemm_model(xx, ww.reshape(5 * c, -1), True, 1, 5 * c)
        a = gather(xx)
        exact, scale = a @ ww.reshape(5 * c, -1).astype(np.float64), np.abs(a) @ np.abs(
            ww.reshape(5 * c, -1).astype(np.float64))
        assert (np.abs(sums - exact) <= 1e-5 * scale).all()
        v = sums if bb is None else (sums + bb).astype(np.float32)
        ours = bf16_round(np.where(v > 0, v, np.float32(slope) * v)).reshape(n, rows, -1)
        plain = fdc.conv5_lrelu_reference_bf16(t(xx), t(ww), None if bb is None else t(bb),
                                               slope)
        assert plain.dtype == torch.bfloat16
        assert within_one_ulp(ours, plain.float().numpy())


@pytest.mark.parametrize("shape", [(64, 37, 24, 40), (5, 13, 16, 24)])
def test_k6_bf16_model_against_float64_and_plain(shape):
    """dW's float32 partials over the splits dw_plan gives the bf16 tiling
    (four at N*R = 2,368; one at 65), summed in split order and rounded to
    bf16 once, against float64 and the plain dW."""
    n, rows, c_in, c_out = shape
    x, _, _, dym = inputs(rows, *shape)
    plan = fdc.dw_plan(n, rows, c_in, c_out, 132, BF16_TILING)
    assert plan.splits == (4 if n * rows > 2000 else 1)
    sums = gemm_model(x, dym.reshape(n * rows, c_out), False, plan.splits, plan.k_chunk)
    a = gather(x).T
    d = dym.reshape(n * rows, c_out).astype(np.float64)
    assert (np.abs(sums - a @ d) <= 1e-5 * (np.abs(a) @ np.abs(d))).all()
    plain = fdc.conv5_dw_reference(t(x), t(dym))
    assert plain.dtype == torch.bfloat16 and plain.shape == (5, c_in, c_out)
    assert within_one_ulp(bf16_round(sums).reshape(5, c_in, c_out), plain.float().numpy())


def test_model_reads_no_padding_and_zero_fills_the_halo():
    """A tile whose shifted rows all fall outside [0, R) sums to zero, and
    staging leaves the rows' padding NaN (the model would carry a NaN into an
    output that read it)."""
    x = np.ones((2, 3, 8), np.float32)
    s = stage_a(x, True, 0, 0, 40).reshape(BM, LDMK)
    assert np.isnan(s[:, BK:]).all()
    # m = (n, r) = (0, 0): dr 0 and 1 read rows -2 and -1 (zero), dr 2 row 0
    assert (s[0, :16] == 0).all() and (s[0, 16:24] == 1).all()
    assert (s[6:, :BK] == 0).all()   # rows past M = 6
    k6 = stage_a(x, False, 0, 0, 6).reshape(BK, LDKN)
    assert (k6[6:, :BM] == 0).all() and np.isnan(k6[:, BM:]).all()


@pytest.mark.parametrize("sm_count", [132, 114, 1])
def test_dw_plan_on_the_bf16_tiling_covers_the_reduction_once(sm_count):
    """Every k in [0, N*R) in exactly one split, none empty, split edges on
    64-wide k tiles (the bf16 kernel refuses others), the workspace one
    float32 dW a split; at the period shapes 320 tiles on 264 block slots
    split four ways."""
    shapes = [(n, r, c, c) for n, r, c in fdc.disc_conv5_shapes(64, 10240).values()]
    for shape in shapes + [(3, 37, 24, 40), (1, 1, 1, 1), (5, 13, 30, 42), (64, 37, 24, 40),
                           (1000, 7, 8, 8), (4096, 1, 4, 4), (11, 12, 1024, 1024)]:
        n, rows, c_in, c_out = shape
        plan = fdc.dw_plan(n, rows, c_in, c_out, sm_count, BF16_TILING)
        k = n * rows
        assert 1 <= plan.splits <= fdc.MAX_SPLITS and plan.k_chunk % BF16_TILING.k_tile == 0
        cover = np.zeros(k, np.int64)
        for z in range(plan.splits):
            lo, hi = z * plan.k_chunk, min((z + 1) * plan.k_chunk, k)
            assert lo < hi, (shape, plan)
            cover[lo:hi] += 1
        assert (cover == 1).all(), (shape, plan)
        assert plan.workspace == (plan.splits * 5 * c_in * c_out if plan.splits > 1 else 0)
        if shape in shapes and sm_count == 132:
            assert plan.splits == 4


def test_wrappers_send_bf16_to_the_bf16_entries(monkeypatch):
    """bf16 tensors reach ``qvc_conv5_lrelu_bf16`` (bias bits as given, the
    output bf16) and ``qvc_conv5_dw_bf16`` (the plan of the bf16 tiling, a
    float32 workspace where it splits) and count in the bf16 stats only;
    float32 still takes the float32 entries and plans."""
    n, rows, c_in, c_out = 64, 37, 24, 40

    def grab_conv(x, w, bias, y, *dims):
        return dims[:4], _read(bias, c_out, ctypes.c_uint16) if bias else None

    def grab_dw(x, dym, dw, ws, *dims):
        return dims[:6], ws

    calls = _fake(monkeypatch, fdc, {"qvc_conv5_lrelu_bf16": grab_conv,
                                     "qvc_conv5_lrelu": grab_conv,
                                     "qvc_conv5_dw_bf16": grab_dw, "qvc_conv5_dw": grab_dw})
    monkeypatch.setattr(fdc, "device_sms", lambda index: 132)
    for dtype, suffix, tiling in ((torch.bfloat16, "_bf16", BF16_TILING),
                                  (torch.float32, "", fdc.F32_TILING)):
        x = torch.zeros(n, rows, c_in, dtype=dtype)
        k = torch.zeros(5, c_in, c_out, dtype=dtype)
        b = torch.full((c_out,), 0.3, dtype=dtype)
        stats = (fdc.STATS, fdc.DW_STATS, fdc.BF16_STATS, fdc.DW_BF16_STATS)
        before = [s.launches for s in stats]
        y = fdc.conv5_lrelu_kernel(x, k, b, 0.1)
        dw = fdc.conv5_dw_kernel(x, torch.zeros(n, rows, c_out, dtype=dtype))
        assert y.dtype == dw.dtype == dtype
        assert y.shape == (n, rows, c_out) and dw.shape == (5, c_in, c_out)
        name, _, (dims, bias) = calls[-2]
        assert name == "qvc_conv5_lrelu" + suffix and dims == (n, rows, c_in, c_out)
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(bf16_values(bias), bf16_round(np.full(c_out, 0.3)))
        name, _, (dims, ws) = calls[-1]
        plan = fdc.dw_plan(n, rows, c_in, c_out, 132, tiling)
        assert name == "qvc_conv5_dw" + suffix
        assert dims == (n, rows, c_in, c_out, plan.splits, plan.k_chunk)
        assert (ws is None) == (plan.workspace == 0)
        bf = dtype == torch.bfloat16
        assert [s.launches for s in stats] == [before[0] + (not bf), before[1] + (not bf),
                                              before[2] + bf, before[3] + bf]
    with pytest.raises(TypeError, match="one dtype"):
        fdc.conv5_lrelu_kernel(x.bfloat16(), k, b, 0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fdc.conv5_dw_kernel(x.half(), x.half())
