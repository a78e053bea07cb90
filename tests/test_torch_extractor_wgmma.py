"""PyTorch port, K7's bf16 mode on its TMA + wgmma body
(``csrc/extractor_wgmma.cu``, ``ops/fused_extractor.py``) on the CPU: the
layout of the produced h in shared memory (even conv0 rows first, the
128-byte swizzle, what each tap's ldmatrix reads, tap 2's one-row shift),
the plan's cover of the output at the encoding batch and at ragged n1, a
numpy model of the whole body tile by tile (h scattered into the swizzled
slices, A gathered from them by the consumers' lane addresses, conv1's
weight read as the TMA boxes land, 24 stages a tile) against the same
implicit GEMM computed without the layout (bit for bit) and against
``extractor_front_reference`` at bf16, and the wrapper's routing through a
fake library. No JAX.

Tolerance: the body against ``extractor_front_reference`` at bf16 within
``PERF.md`` section 2's bf16 gate, max|model - plain| <= max(1e-2
max|plain|, two bf16 ulps of it) (the model sums in float64, the plain
convolution in float32).
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_support import bf16_values

from quickvc_tpu_torch.ops import fused_extractor as fe
from quickvc_tpu_torch.utils import bf16

C, ROWS, SLICE, HROWS = fe.WGMMA_CHANNELS, fe.WGMMA_ROWS, fe.WGMMA_SLICE, fe.WGMMA_HROWS
H_BYTES = HROWS * 128


def bf16_round(x) -> np.ndarray:
    return bf16_values(bf16.to_bits(np.asarray(x, np.float32)))


def lane_address(tap: int, kk: int, warp: int, lane: int) -> int:
    """The consumer's ldmatrix address (bytes into a slice) of lane ``lane``
    of warp ``warp`` for tap ``tap``'s k16 step ``kk``: tile row 16 warp +
    lane % 16, chunk 2 kk + lane // 16, as the kernel computes it."""
    row = fe.front_h_row(2 * (16 * warp + lane % 16) + tap)
    return row * 128 + (((2 * kk + lane // 16) ^ (row & 7)) << 4)


def test_h_slice_layout_covers_every_byte_once():
    """129 rows x 64 channels of bf16 fill the slice's 16,512 bytes, each
    value at its own 2-byte slot, each row's 8 chunks a permutation of the
    row's 8 16-byte units."""
    seen = np.zeros(H_BYTES, int)
    for t in range(HROWS):
        row = fe.front_h_row(t)
        assert 0 <= row < HROWS
        chunks = set()
        for c in range(SLICE):
            at = fe.front_h_offset(row, c)
            assert at % 2 == 0 and row * 128 <= at < row * 128 + 128
            seen[at: at + 2] += 1
            chunks.add(at // 16)
        assert len(chunks) == 8
    assert (seen == 1).all()


@pytest.mark.parametrize("tap", [0, 1, 2])
def test_each_tap_reads_rows_2u_plus_j_on_eight_bank_groups(tap):
    """Tap j of output row u reads conv0 row 2 u + j: even rows 0 .. 64 for
    taps 0 and 2 (tap 2 one row down), odd rows for tap 1. Every ldmatrix
    phase (the 8 lanes of one 8 x 8 matrix) reads 8 distinct 16-byte bank
    groups, tap 2's shift included, and the 16 bytes a lane reads are the
    8 channels of its row and chunk."""
    want = {0: lambda u: u, 1: lambda u: ROWS + 1 + u, 2: lambda u: u + 1}[tap]
    for u in range(ROWS):
        assert fe.front_h_row(2 * u + tap) == want(u)
    for warp in range(4):
        for kk in range(4):
            addrs = [lane_address(tap, kk, warp, lane) for lane in range(32)]
            for m in range(4):   # the four matrices of ldmatrix.x4, 8 lanes each
                groups = {(a // 16) % 8 for a in addrs[8 * m: 8 * m + 8]}
                assert len(groups) == 8, (warp, kk, m)
            for lane, a in enumerate(addrs):
                row = fe.front_h_row(2 * (16 * warp + lane % 16) + tap)
                first = 16 * kk + 8 * (lane // 16)
                assert [fe.front_h_offset(row, c) for c in range(first, first + 8)] == \
                    list(range(a, a + 16, 2))


@pytest.mark.parametrize("batch,t_len,sms", [(16, 96080, 132), (3, 32083, 132), (1, 1333, 132),
                                             (16, 96080, 114), (5, 4003, 8)])
def test_plan_covers_every_output_row_once(batch, t_len, sms):
    """The clusters' tile pairs cover every (item, row) of the output once;
    a pair's second tile exists only where the tile count is odd, and then
    once. At the encoding batch: 151 tiles an item, 2,416 tiles, 1,208
    pairs on 66 clusters of 2 CTAs (132 SMs)."""
    n1 = fe.front_rows(t_len)
    plan = fe.front_wgmma_plan(batch, n1, sms)
    assert plan.tiles_per_batch == -(-n1 // ROWS) and plan.tiles == batch * plan.tiles_per_batch
    assert plan.clusters == min(plan.pairs, sms // 2) and 2 * plan.pairs >= plan.tiles
    seen = np.zeros((batch, n1), int)
    dummies = 0
    for k in range(plan.clusters):
        for pair in plan.items(k):
            for tile in pair:
                if tile >= plan.tiles:
                    dummies += 1
                    continue
                b, u0 = divmod(tile, plan.tiles_per_batch)
                seen[b, ROWS * u0: min(ROWS * (u0 + 1), n1)] += 1
    assert (seen == 1).all() and dummies == plan.tiles % 2
    if (batch, t_len, sms) == (16, 96080, 132):
        assert (n1, plan.tiles_per_batch, plan.tiles, plan.pairs, plan.clusters) == \
            (9607, 151, 2416, 1208, 66)


def _front(batch, t_len, seed):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy(0.3 * rng.standard_normal((batch, t_len)).astype(np.float32))
    w0 = torch.from_numpy(0.3 * rng.standard_normal((C, 1, 10)).astype(np.float32))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((C, C, 3)).astype(np.float32) / (3 * C) ** 0.5)
    return wav.bfloat16(), w0, gamma, beta, w1


def _h(wav, w0, gamma, beta) -> np.ndarray:
    """h (B, Tc, C) as bf16 values: conv0 -> affine -> tanh GELU at bf16, as
    ``extractor_front_reference`` computes it."""
    scale, shift = fe.groupnorm_affine_closed_form(wav, w0, gamma, beta)
    y = F.conv1d(wav.float()[:, None], w0.bfloat16().float(), stride=5)
    x = F.gelu((y * scale[:, :, None] + shift[:, :, None]).bfloat16(), approximate="tanh")
    return x.float().numpy().transpose(0, 2, 1)


def body_model(h: np.ndarray, w1k: np.ndarray, n1: int, plan) -> tuple[np.ndarray, np.ndarray]:
    """The body's float64 sums (B, n1, C) through its layout, and the same
    sums without it. Each CTA tile: per slice of 64 in-channels, h's 129
    rows scattered into a slice's bytes (rows past the wave's conv0 rows
    NaN: they may only reach rows u >= n1); per tap, A (64 rows x 64) from
    the slice by the consumers' lane addresses, B the TMA boxes of w1k
    [tap][out][in] (each CTA's half of the 512 outputs, both halves in both
    CTAs), the stage's product added in stage order."""
    batch, tc, _ = h.shape
    sums = np.full((batch, n1, C), np.nan)
    direct = np.full((batch, n1, C), np.nan)
    for k in range(plan.clusters):
        for pair in plan.items(k):
            for tile in pair:
                if tile >= plan.tiles:
                    continue
                b, u_blk = divmod(tile, plan.tiles_per_batch)
                u0 = ROWS * u_blk
                t = 2 * u0 + np.arange(HROWS)
                rows = np.full((HROWS, C), np.nan)
                rows[t < tc] = h[b, t[t < tc]]
                acc, ref = np.zeros((ROWS, C)), np.zeros((ROWS, C))
                for sl in range(C // SLICE):
                    slice_bits = np.zeros(H_BYTES // 2)
                    for r in range(HROWS):
                        at = [fe.front_h_offset(fe.front_h_row(r), c) // 2 for c in range(SLICE)]
                        slice_bits[at] = rows[r, SLICE * sl: SLICE * (sl + 1)]
                    for tap in range(3):
                        a = np.zeros((ROWS, SLICE))
                        for warp in range(4):
                            for kk in range(4):
                                for lane in range(32):
                                    at = lane_address(tap, kk, warp, lane) // 2
                                    first = 16 * kk + 8 * (lane // 16)
                                    a[16 * warp + lane % 16, first: first + 8] = \
                                        slice_bits[at: at + 8]
                        boxes = np.concatenate([w1k[tap, 256 * r: 256 * (r + 1),
                                                    SLICE * sl: SLICE * (sl + 1)]
                                                for r in range(2)])
                        acc += a @ boxes.T
                        ref += rows[tap: tap + 2 * ROWS: 2, SLICE * sl: SLICE * (sl + 1)] @ \
                            w1k[tap, :, SLICE * sl: SLICE * (sl + 1)].T
                keep = min(ROWS, n1 - u0)
                sums[b, u0: u0 + keep], direct[b, u0: u0 + keep] = acc[:keep], ref[:keep]
    return sums, direct


@pytest.mark.parametrize("batch,t_len", [(1, 1333), (2, 683)])
def test_body_model_matches_the_plain_front(batch, t_len):
    """(1, 1333): n1 = 132, three tiles (the last of 4 rows) and a pair's
    empty second tile; (2, 683): n1 = 67 twice, ragged in both items. The
    layout's sums equal the implicit GEMM's without it bit for bit, and the
    epilogue (round, tanh GELU in float32, round) is within the bf16 gate
    of ``extractor_front_reference``."""
    wav, w0, gamma, beta, w1 = _front(batch, t_len, t_len)
    n1 = fe.front_rows(t_len)
    plan = fe.front_wgmma_plan(batch, n1)
    w1k = bf16_round(w1.numpy().transpose(2, 0, 1))
    sums, direct = body_model(_h(wav, w0, gamma, beta), w1k, n1, plan)
    np.testing.assert_array_equal(sums, direct)
    assert not np.isnan(sums).any()
    pre = torch.from_numpy(sums.astype(np.float32)).bfloat16()
    out = F.gelu(pre, approximate="tanh").float().numpy()
    plain = fe.extractor_front_reference(wav, w0, gamma, beta, w1).float().numpy()
    peak = np.abs(plain).max()
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert np.abs(out - plain).max() <= max(1e-2 * peak, 2 * ulp)


def _read(ptr: int, n: int, kind) -> np.ndarray:
    return np.ctypeslib.as_array((kind * n).from_address(ptr)).copy()


@pytest.mark.parametrize("c", [512, 64])
def test_wrapper_routes_by_width(monkeypatch, c):
    """C = 512 goes to the wgmma entry with conv1's weight as bf16
    [tap][out][in] and the plan's clusters, counted in BF16_STATS and
    WGMMA_STATS; C = 64 to the mma.sync entry ([tap][in][out] in
    ``bf16_channel_order``), counted in BF16_STATS only."""
    rng = np.random.default_rng(c)
    t_len = 4003
    wav = torch.from_numpy(0.3 * rng.standard_normal((2, t_len)).astype(np.float32)).bfloat16()
    w0 = torch.from_numpy(0.3 * rng.standard_normal((c, 1, 10)).astype(np.float32))
    gamma, beta = torch.ones(c), torch.zeros(c)
    w1 = torch.from_numpy(rng.standard_normal((c, c, 3)).astype(np.float32) / 10)
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args[6:-1], _read(args[4], 3 * c * c, ctypes.c_uint16)))
                return 0
            return call

    monkeypatch.setattr(fe, "library", lambda: FakeLib())
    monkeypatch.setattr(fe, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fe, "device_sms", lambda index: 132)
    monkeypatch.setattr(fe, "require_device", lambda name, *ts: None)
    before = (fe.BF16_STATS.launches, fe.WGMMA_STATS.launches)
    out = fe.extractor_front_kernel(wav, w0, gamma, beta, w1)
    n1 = fe.front_rows(t_len)
    assert out.shape == (2, n1, c) and out.dtype == torch.bfloat16
    (name, ints, w1t), = calls
    if c == 512:
        assert name == "qvc_extractor_front_bf16_wgmma" and fe.takes_wgmma(c)
        assert ints == (2, t_len, c, n1, fe.front_wgmma_plan(2, n1).clusters)
        want = w1.numpy().transpose(2, 0, 1)
    else:
        assert name == "qvc_extractor_front_bf16" and not fe.takes_wgmma(c)
        assert ints == (2, t_len, c, n1)
        want = w1.numpy().transpose(2, 1, 0)[:, :, fe.bf16_channel_order(c).numpy()]
    np.testing.assert_array_equal(bf16_values(w1t).reshape(3, c, c), bf16_round(want))
    assert (fe.BF16_STATS.launches, fe.WGMMA_STATS.launches) == \
        (before[0] + 1, before[1] + (c == 512))
