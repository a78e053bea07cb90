"""PyTorch port, the arithmetic of K7 (HuBERT's extractor front,
``csrc/fused_extractor.cu``) and of K8's four linear layers
(``csrc/fused_transformer.cu``) emulated in numpy, and K8's host plan
(``ops/fused_transformer.py:linear_plan``).

K7 is emulated block by block as the kernel computes it: a 64-row tile
stages its wave segment (zeros past the wave's end), computes the 129
conv0 rows its output rows need (10 float32 multiply-adds, the closed-form
affine, exact GELU) and splits each value into its TF32 big and small parts
once, at production; tap j of output row u reads conv0 row 2u + j; the mma
computes out^T, conv1's weight as its A operand and the split h as its B;
k walks in the kernel's order (slice of 8 in-channels, tap, channel), each
8-wide k step's three products summed from zero and added to the float32
accumulator (``torch_port_support.mma`` with ``promote``, as
``csrc/tf32x3.cuh:mma_3xtf32_promoted`` computes); then GELU, and rows past
n1 dropped. K8's linears: x (M, K) @ W (N, K)^T in the same 3xTF32
arithmetic, the reduction cut as ``linear_plan`` cuts it into float32
partials summed in split order, then the epilogue (bias, bias + GELU, bias
+ residual).

Tolerances: the kernels' gates, K7 atol 5e-4 / rtol 1e-3 and K8 atol 1e-4 /
rtol 1e-3, against float64 and against the plain versions. Single-pass TF32
is shown to land well above 3xTF32's error (a ratio, not a threshold). No
JAX, no card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_support import mma, split

from quickvc_tpu_torch.ops import fused_extractor as fe
from quickvc_tpu_torch.ops import fused_transformer as ft

# K7's tiling (csrc/fused_extractor.cu: KC, BM)
KC, BM = 8, 64
HROWS = 2 * BM + 1


def gelu32(x: np.ndarray) -> np.ndarray:
    return F.gelu(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


def gelu64(x: np.ndarray) -> np.ndarray:
    return F.gelu(torch.from_numpy(np.asarray(x, np.float64))).numpy()


def front_inputs(rng, b: int, t_len: int, c: int):
    """Wave, conv0 (C, 1, 10), GroupNorm affine, conv1 (C, C, 3), numpy float32."""
    wav = (0.3 * rng.standard_normal((b, t_len))).astype(np.float32)
    w0 = (0.3 * rng.standard_normal((c, 1, 10))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w1 = (rng.standard_normal((c, c, 3)) / np.sqrt(3 * c)).astype(np.float32)
    return wav, w0, gamma, beta, w1


def k_order(c: int) -> tuple[np.ndarray, np.ndarray]:
    """(tap, in-channel) of each k of the kernel's reduction: slices of KC
    channels, in each slice the three taps, in each tap the KC channels."""
    s, j, cc = np.meshgrid(np.arange(c // KC), np.arange(3), np.arange(KC), indexing="ij")
    return j.ravel(), (KC * s + cc).ravel()


def k7_body(wav, w0, scale, shift, w1, passes: int = 3) -> np.ndarray:
    """K7 over wav (B, T): (B, n1, C), one BM-row tile at a time."""
    b, t_len = wav.shape
    c = w0.shape[0]
    n1 = fe.front_rows(t_len)
    taps, chans = k_order(c)
    bmat = w1.transpose(2, 1, 0)[taps, chans]              # (3C, C): w1t[j, c, :]
    w0m = w0[:, 0, :]                                      # (C, 10)
    out = np.empty((b, n1, c), np.float32)
    for bi in range(b):
        for u0 in range(0, n1, BM):
            seg = np.zeros(5 * (HROWS - 1) + 10, np.float32)
            part = wav[bi, 10 * u0 : 10 * u0 + seg.size]
            seg[: part.size] = part
            frames = seg[5 * np.arange(HROWS)[:, None] + np.arange(10)]      # (257, 10)
            x = np.zeros((HROWS, c), np.float32)
            for k in range(10):
                x = (x + frames[:, k:k + 1] * w0m[:, k]).astype(np.float32)
            h = gelu32(x * scale[bi] + shift[bi])
            rows = 2 * np.arange(BM) + taps[:, None]           # (3C, BM): row 2u + j
            zero = np.zeros((c, BM), np.float32)                 # out^T of the tile
            if passes == 3:
                big, small = split(h)                          # at production
                acc = mma(zero, bmat.T, None, 3, promote=True,
                          b_parts=(big[rows, chans[:, None]], small[rows, chans[:, None]]))
            else:
                acc = mma(zero, bmat.T, h[rows, chans[:, None]], 1, promote=True)
            m = min(BM, n1 - u0)
            out[bi, u0 : u0 + m] = gelu32(acc.T[:m])
    return out


def front64(wav, w0, scale, shift, w1) -> np.ndarray:
    """The same chain in float64 convolutions (from the same affine)."""
    b, t_len = wav.shape
    tc = (t_len - 10) // 5 + 1
    frames = wav.astype(np.float64)[:, 5 * np.arange(tc)[:, None] + np.arange(10)]
    h = gelu64(frames @ w0[:, 0, :].T.astype(np.float64) * scale[:, None] + shift[:, None])
    n1 = fe.front_rows(t_len)
    y = sum(h[:, j : j + 2 * n1 - 1 : 2] @ w1[:, :, j].T.astype(np.float64) for j in range(3))
    return gelu64(y)


def affine(wav, w0, gamma, beta):
    scale, shift = fe.groupnorm_affine_closed_form(*(torch.from_numpy(a) for a in
                                                     (wav, w0, gamma, beta)))
    return scale.numpy(), shift.numpy()


def within(ours, ref, atol: float, rtol: float) -> bool:
    return bool(np.all(np.abs(ours - ref) <= atol + rtol * np.abs(ref)))


@pytest.mark.parametrize("b,t_len,c", [(2, 1510, 64), (1, 1333, 32), (2, 700, 32)])
def test_k7_body_matches_float64_and_the_plain_version(rng, b, t_len, c):
    """n1 = 150 (two full 64-row tiles and a ragged one), 132 and 68, at C =
    64 and 32."""
    wav, w0, gamma, beta, w1 = front_inputs(rng, b, t_len, c)
    scale, shift = affine(wav, w0, gamma, beta)
    ours = k7_body(wav, w0, scale, shift, w1)
    assert ours.shape == (b, fe.front_rows(t_len), c) and np.isfinite(ours).all()
    assert within(ours, front64(wav, w0, scale, shift, w1), 5e-4, 1e-3)
    plain = fe.extractor_front_reference(*(torch.from_numpy(a)
                                           for a in (wav, w0, gamma, beta, w1))).numpy()
    assert within(ours, plain, 5e-4, 1e-3)


def test_k7_reads_each_conv0_row_where_its_taps_need_it():
    """Tap j of output row u reads conv0 row 2u + j; a tile's 64 rows need
    129 conv0 rows, each read by at most two (row, tap) slots, and the k
    order visits every (tap, channel) once."""
    taps, chans = k_order(32)
    rows = 2 * np.arange(BM)[:, None] + np.arange(3)
    assert rows.max() == HROWS - 1
    counts = np.bincount(rows.ravel(), minlength=HROWS)
    assert counts.min() == 1 and counts.max() == 2 and (counts[1::2] == 1).all()
    assert sorted(zip(taps, chans)) == [(j, c) for j in range(3) for c in range(32)]


def linear_inputs(rng, m: int, n: int, k: int):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, bias, res


def linear_body(x, w, bias, epi: str, res=None, sm_count: int = 132,
                passes: int = 3) -> np.ndarray:
    """One of K8's GEMMs: partials over linear_plan's K ranges, summed in
    split order, then the epilogue."""
    m, k = x.shape
    plan = ft.linear_plan(m, w.shape[0], k, sm_count)
    parts = [mma(np.zeros((m, w.shape[0]), np.float32), x[:, lo:lo + plan.k_chunk],
                 w[:, lo:lo + plan.k_chunk].T, passes, promote=True)
             for lo in range(0, k, plan.k_chunk)]
    assert len(parts) == plan.splits
    acc = parts[0]
    for p in parts[1:]:
        acc = (acc + p).astype(np.float32)
    v = (acc + bias).astype(np.float32)
    if epi == "gelu":
        return gelu32(v)
    return (v + res).astype(np.float32) if epi == "residual" else v


def linear64(x, w, bias, epi: str, res=None) -> np.ndarray:
    v = x.astype(np.float64) @ w.T.astype(np.float64) + bias
    if epi == "gelu":
        return gelu64(v)
    return v + res if epi == "residual" else v


# (N, K, epilogue) of in_proj, out_proj, linear1 and linear2 at HuBERT-base's
# reductions, narrow in N
LINEARS = [(96, 768, "bias"), (32, 768, "residual"), (128, 768, "gelu"), (32, 3072, "residual")]


@pytest.mark.parametrize("sm_count", [132, 1])
@pytest.mark.parametrize("n,k,epi", LINEARS)
def test_k8_linears_match_float64(rng, n, k, epi, sm_count):
    """M = 37, ragged against the 256-row tile: split four ways on 132 SMs,
    unsplit on one."""
    x, w, bias, res = linear_inputs(rng, 37, n, k)
    assert ft.linear_plan(37, n, k, sm_count).splits == (4 if sm_count == 132 else 1)
    ours = linear_body(x, w, bias, epi, res, sm_count)
    assert ours.shape == (37, n) and np.isfinite(ours).all()
    assert within(ours, linear64(x, w, bias, epi, res), 1e-4, 1e-3)


def test_single_pass_tf32_is_far_less_accurate(rng):
    wav, w0, gamma, beta, w1 = front_inputs(rng, 1, 1333, 32)
    scale, shift = affine(wav, w0, gamma, beta)
    ref = front64(wav, w0, scale, shift, w1)
    err3 = np.abs(k7_body(wav, w0, scale, shift, w1) - ref).max()
    err1 = np.abs(k7_body(wav, w0, scale, shift, w1, passes=1) - ref).max()
    assert err1 > 30 * err3
    x, w, bias, res = linear_inputs(rng, 37, 32, 3072)
    ref = linear64(x, w, bias, "residual", res)
    err3 = np.abs(linear_body(x, w, bias, "residual", res) - ref).max()
    err1 = np.abs(linear_body(x, w, bias, "residual", res, passes=1) - ref).max()
    assert err1 > 30 * err3


# (M, N, K) of the layer's GEMMs at the encoding batches (16 x 250 and 16 x
# 300 frames) and at ragged M
ENCODING = [(m, n, k) for m in (4000, 4800) for n, k in ((2304, 768), (768, 768), (3072, 768),
                                                         (768, 3072))]
RAGGED = [(m, n, k) for m in (1, 37, 111, 255, 257, 900, 4799) for n, k in ((2304, 768),
                                                                           (768, 3072))]


@pytest.mark.parametrize("sm_count", [132, 114, 1])
def test_linear_plan_covers_each_output_once(sm_count):
    """The grid's tiles cover every output once, every k in [0, K) lies in
    exactly one split, no split is empty, split edges sit on K-tile
    multiples, and the workspace holds one partial C a split."""
    for m, n, k in ENCODING + RAGGED:
        plan = ft.linear_plan(m, n, k, sm_count)
        assert 1 <= plan.splits <= ft.MAX_SPLITS and plan.k_chunk % ft.K_TILE == 0
        cover = np.zeros(k, np.int64)
        for z in range(plan.splits):
            lo, hi = z * plan.k_chunk, min((z + 1) * plan.k_chunk, k)
            assert lo < hi, (m, n, k, plan)
            cover[lo:hi] += 1
        assert (cover == 1).all(), (m, n, k, plan)
        assert plan.workspace == (plan.splits * m * n if plan.splits > 1 else 0)
        rows = np.zeros(m, np.int64)
        for m0 in range(0, -(-m // ft.TILE_M) * ft.TILE_M, ft.TILE_M):
            rows[m0 : m0 + ft.TILE_M] += 1
        cols = np.zeros(n, np.int64)
        for n0 in range(0, -(-n // ft.TILE_N) * ft.TILE_N, ft.TILE_N):
            cols[n0 : n0 + ft.TILE_N] += 1
        assert (rows == 1).all() and (cols == 1).all()


def test_linear_plan_at_the_encoding_batch():
    """At 16 x 300 frames no GEMM splits (one wave of 114 tiles for the
    narrow ones, whose partials would cost more than the idle SMs); one
    300-frame item splits every GEMM."""
    assert all(p.splits == 1 for p in ft.layer_plans(4800, 768, 3072))
    assert all(p.splits > 1 for p in ft.layer_plans(300, 768, 3072))


def test_layer_wrapper_hands_the_kernel_its_plans(monkeypatch):
    """The wrapper passes each GEMM's (splits, k_chunk) in layer order and a
    workspace of the largest plan's size (the launch itself faked: no card
    here)."""
    from quickvc_tpu_torch.models.hubert import TransformerLayer

    calls, sizes = [], []
    real_empty = torch.empty

    class FakeLib:
        def qvc_transformer_layer(self, *args):
            calls.append(args)
            return 0

    def spy_empty(*shape, **kw):
        sizes.append(shape)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(ft, "require_cuda", lambda *a, **kw: torch.float32)
    monkeypatch.setattr(ft, "library", lambda: FakeLib())
    monkeypatch.setattr(ft, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(ft, "device_sms", lambda index: 132)
    monkeypatch.setattr(torch, "empty", spy_empty)
    layer = TransformerLayer(768, 12, 3072)
    for b, t_len in [(1, 300), (16, 300)]:
        calls.clear()
        sizes.clear()
        before = ft.STATS.launches
        ft.transformer_layer_kernel(real_empty(b, t_len, 768), layer)
        plans = ft.layer_plans(b * t_len, 768, 3072)
        assert ft.STATS.launches == before + 1
        args = calls[0]
        assert list(args[-9:-1]) == [v for p in plans for v in (p.splits, p.k_chunk)]
        workspace = max(p.workspace for p in plans)
        assert (args[18] is None) == (workspace == 0)
        assert ((workspace,) in sizes) == (workspace > 0)
