"""PyTorch port, the bf16 GEMM core (``csrc/bf16_gemm.cuh``) and the bf16
modes of K7-K10 on the CPU (no JAX): a numpy model of the core's fragment
layout, and of K7's bf16 conv1, against float64 products; K8's bf16 GEMMs
(on the wgmma core, modelled in ``test_torch_wgmma_bf16.py``) and their
plans; the wrappers handing bf16 tensors to the bf16 entries with the
arguments they need.

The model follows the kernels step by step: operands staged in shared
memory as the 16-byte copies stage them (rows past M or N and chunks past
the block's K range zero), each fragment read by ``ldmatrix.x4`` (``.trans``
for K7's weight) from the row address each lane gives, one
``mma.sync.m16n8k16`` per tile in the PTX fragment layout (bf16 products
exact, summed in float32), and the accumulators stored where the epilogue
stores them; split-K partials summed in split order. Every output must be
written exactly once per split and match the float64 product within float32
summation error (|err| <= 1e-5 sum |a||b|).
"""

import ctypes

import numpy as np
import pytest
import torch

from torch_port_support import bf16_values

from quickvc_tpu_torch.utils import bf16

LANES = np.arange(32)
G, T4 = LANES // 4, LANES % 4
PAIR = 2 * T4[:, None] + np.arange(2)   # (32, 2): the two k (or n) slots of a lane


def bf16_round(x: np.ndarray) -> np.ndarray:
    return bf16_values(bf16.to_bits(np.asarray(x, np.float32)))


def ldmatrix_x4(smem: np.ndarray, addr: np.ndarray, trans: bool = False) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4(.trans).b16: lane l gives the address of
    row l % 8 of matrix l // 8 (``addr``, in values of the flat ``smem``); lane
    l receives, in register m, row l // 4, columns 2 (l % 4) and + 1 of matrix
    m (of its transpose with .trans). Returns (32 lanes, 4 registers, 2 values)."""
    mats = smem[addr[:, None] + np.arange(8)].reshape(4, 8, 8)
    if trans:
        mats = mats.transpose(0, 2, 1)
    return mats[:, G[:, None], PAIR].transpose(1, 0, 2)


def mma(acc: np.ndarray, a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """acc (32, 4) += A B on one m16n8k16 tile from the lanes' registers: A
    (16 x 16) a0 (row g, k 2t..2t+1), a1 (g + 8, same k), a2 (g, k + 8), a3
    (g + 8, k + 8); B (16 x 8) b0 (k 2t..2t+1, column g), b1 (k + 8); C
    c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    rows = G[:, None]
    A[rows, PAIR], A[rows + 8, PAIR], A[rows, PAIR + 8], A[rows + 8, PAIR + 8] = a.transpose(1, 0, 2)
    B[PAIR, rows], B[PAIR + 8, rows] = b0, b1
    d = (A @ B).astype(np.float32)   # exact products, one float32 rounding of the sum
    acc += np.stack([d[G, 2 * T4], d[G, 2 * T4 + 1], d[G + 8, 2 * T4], d[G + 8, 2 * T4 + 1]], 1)


# csrc/bf16_gemm.cuh: a warp's m16n8k16 tiles
MT, NT = 4, 8


@pytest.mark.parametrize("m,n,k", [(150, 136, 200), (40, 136, 520)])
def test_linear_core_model_against_float64(m, n, k):
    """K8's bf16 GEMM core (the persistent wgmma core since it left this
    file's mma.sync linear layer; ``test_torch_wgmma_bf16.py`` models it),
    ragged against its 128-row tiles and 64-wide k tiles, on its plan and,
    at (40, 136, 520), split 2 ways (the second split's range not a whole
    number of k tiles)."""
    from test_torch_wgmma_bf16 import linear_model

    from quickvc_tpu_torch.ops import fused_transformer as ft

    rng = np.random.default_rng(m + k)
    a, w = bf16_round(rng.standard_normal((m, k))), bf16_round(rng.standard_normal((n, k)))
    plans = [ft.wgmma_plan(m, n, k)]
    assert plans[0].splits == 1
    if k == 520:
        plans.append(ft.WgmmaPlan(plans[0].bn, 2, 320, 2 * m * n))
    exact = a.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(a).astype(np.float64) @ np.abs(w).astype(np.float64).T
    for plan in plans:
        ours = linear_model(a, w, plan)
        assert (np.abs(ours - exact) <= 1e-5 * scale).all()


# csrc/fused_extractor.cu, namespace front_bf16
KC, FBM, LDH, LDW = 16, 64, 24, 520
HEVEN = FBM + 1


def front_conv1_model(h: np.ndarray, w1: np.ndarray, n1: int) -> np.ndarray:
    """conv1 of the bf16 front as extractor_front_bf16_kernel computes it from
    h (rows 2 n1 + 1, C) and conv1's weight w1 (C, C, 3): the staged weight
    W[k][position] (w1t in bf16_channel_order), h's even and odd rows in two
    arrays, A through ldmatrix.x4.trans, B through ldmatrix.x4, the
    epilogue's stores of channel pairs. Only the warps whose 64 positions
    reach into C are modelled (the others store nothing)."""
    from quickvc_tpu_torch.ops.fused_extractor import bf16_channel_order

    c = w1.shape[0]
    w1t = w1.transpose(2, 1, 0)[:, :, bf16_channel_order(c).numpy()]   # [tap][in][position]
    out = np.full((n1, c), np.nan, np.float32)
    lrow, lcol = 8 * (LANES >> 4) + (LANES & 7), 8 * ((LANES >> 3) & 1)
    for u0 in range(0, n1, FBM):
        rows = np.zeros((2 * FBM + 1, c), np.float32)   # conv0 rows 2 u0 .. 2 u0 + 128
        have = min(2 * FBM + 1, h.shape[0] - 2 * u0)
        rows[:have] = h[2 * u0: 2 * u0 + have]
        for warp in range(-(-c // 64)):
            wc0 = 64 * warp
            acc = np.zeros((MT, 8, 32, 4), np.float32)
            for t in range(c // KC):
                W = np.zeros((3 * KC, LDW), np.float32)
                W[:, :c] = w1t[:, KC * t: KC * (t + 1)].reshape(3 * KC, c)
                H = np.zeros(((HEVEN + FBM), LDH), np.float32)
                H[:HEVEN, :KC] = rows[0::2, KC * t: KC * (t + 1)]
                H[HEVEN:, :KC] = rows[1::2, KC * t: KC * (t + 1)]
                W, H = W.reshape(-1), H.reshape(-1)
                for j in range(3):
                    af = [ldmatrix_x4(W, lrow * LDW + wc0 + lcol + j * KC * LDW + 16 * i, True)
                          for i in range(MT)]
                    hj = lrow * LDH + lcol + (HEVEN * LDH if j == 1 else LDH if j == 2 else 0)
                    for jp in range(4):
                        bf = ldmatrix_x4(H, hj + 16 * jp * LDH)
                        for i in range(MT):
                            mma(acc[i, 2 * jp], af[i], bf[:, 0], bf[:, 1])
                            mma(acc[i, 2 * jp + 1], af[i], bf[:, 2], bf[:, 3])
            for i in range(MT):
                ch = wc0 + 16 * i + 2 * G
                for jn in range(8):
                    for hh in range(2):
                        u = u0 + 8 * jn + 2 * T4 + hh
                        ok = (ch < c) & (u < n1)
                        for e in range(2):
                            assert np.isnan(out[u[ok], ch[ok] + e]).all()
                            out[u[ok], ch[ok] + e] = acc[i, jn, ok, 2 * e + hh]
    assert not np.isnan(out).any(), "an output no warp wrote"
    return out


@pytest.mark.parametrize("c,n1", [(48, 70), (32, 64)])
def test_front_conv1_model_against_float64(c, n1):
    """C = 48: the last 16 of a warp's 64 positions past C; n1 = 70: a ragged
    second row tile."""
    rng = np.random.default_rng(c)
    h = bf16_round(rng.standard_normal((2 * n1 + 1, c)))
    w1 = bf16_round(rng.standard_normal((c, c, 3)) / np.sqrt(3 * c))
    ours = front_conv1_model(h, w1, n1)
    taps = np.stack([h[j: j + 2 * n1: 2] for j in range(3)], 0).astype(np.float64)
    exact = np.einsum("jui,oij->uo", taps, w1.astype(np.float64))
    scale = np.einsum("jui,oij->uo", np.abs(taps), np.abs(w1.astype(np.float64)))
    assert (np.abs(ours - exact) <= 1e-5 * scale).all()


@pytest.mark.parametrize("sm_count", [132, 114])
def test_bf16_plan_covers_each_output_once(sm_count):
    """K8's bf16 plans (``wgmma_plan``): splits on 64-wide k-tile edges that
    cover the reduction once, none empty, at the shapes the layer gives it
    (the live windows' M = N x 80 rows included)."""
    from quickvc_tpu_torch.ops import fused_transformer as ft

    for m in (37, 160, 300, 4800, 5120):
        for p, (n, k) in zip(ft.wgmma_layer_plans(m, 768, 3072, sm_count),
                             ((2304, 768), (768, 768), (3072, 768), (768, 3072))):
            assert 1 <= p.splits <= ft.MAX_SPLITS and p.k_chunk % ft.WG_K_TILE == 0
            assert (p.splits - 1) * p.k_chunk < k <= p.splits * p.k_chunk
            assert p.workspace == (p.splits * m * n if p.splits > 1 else 0)
    assert all(p.splits == 1 for p in ft.wgmma_layer_plans(4800, 768, 3072, 132))


def _read(ptr: int, n: int, kind) -> np.ndarray:
    """n values of ctypes ``kind`` at a tensor's data pointer (while it lives)."""
    return np.ctypeslib.as_array((kind * n).from_address(ptr)).copy()


def _fake(monkeypatch, module, entries):
    """Route ``module``'s kernel calls to a fake library recording each call."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            if name not in entries:
                raise AttributeError(name)

            def call(*args):
                calls.append((name, args, entries[name](*args)))
                return 0
            return call

    monkeypatch.setattr(module, "library", lambda: FakeLib())
    monkeypatch.setattr(module, "stream_ptr", lambda t: 0)
    if hasattr(module, "device_sms"):
        monkeypatch.setattr(module, "device_sms", lambda index: 132)
    monkeypatch.setattr(module, "require_cuda",
                        lambda name, *ts, **kw: module.require_dtype(name, *ts, **kw))
    if hasattr(module, "require_device"):
        monkeypatch.setattr(module, "require_device", lambda name, *ts: None)
    return calls


def test_front_wrapper_sends_bf16_to_the_bf16_entry(monkeypatch):
    """A bf16 wave reaches ``qvc_extractor_front_bf16`` with conv0's weight
    rounded to bf16 (as float32), the affine from the unrounded weight, and
    conv1's weight as bf16 [tap][in][position]; it counts in BF16_STATS."""
    from quickvc_tpu_torch.ops import fused_extractor as fe

    c, t_len = 32, 4003
    rng = np.random.default_rng(5)
    wav = torch.from_numpy(0.3 * rng.standard_normal((2, t_len)).astype(np.float32)).bfloat16()
    w0 = torch.from_numpy(0.3 * rng.standard_normal((c, 1, 10)).astype(np.float32))
    gamma, beta = torch.ones(c) + 0.1, torch.zeros(c) - 0.1
    w1 = torch.from_numpy(rng.standard_normal((c, c, 3)).astype(np.float32) / 10)

    def grab(wav_p, w0_p, sc_p, sh_p, w1t_p, out_p, b, t, cc, n1, stream):
        return (_read(w0_p, cc * 10, ctypes.c_float), _read(sc_p, b * cc, ctypes.c_float),
                _read(w1t_p, 3 * cc * cc, ctypes.c_uint16), (b, t, cc, n1))

    calls = _fake(monkeypatch, fe, {"qvc_extractor_front_bf16": grab})
    before = (fe.STATS.launches, fe.BF16_STATS.launches)
    out = fe.extractor_front_kernel(wav, w0, gamma, beta, w1)
    assert out.dtype == torch.bfloat16 and out.shape == (2, fe.front_rows(t_len), c)
    assert (fe.STATS.launches, fe.BF16_STATS.launches) == (before[0], before[1] + 1)
    name, _, (w0b, scale, w1t, dims) = calls[-1]
    assert dims == (2, t_len, c, fe.front_rows(t_len))
    np.testing.assert_array_equal(w0b, bf16_round(w0.numpy().reshape(c, 10)).reshape(-1))
    sc, _ = fe.groupnorm_affine_closed_form(wav, w0, gamma, beta)
    np.testing.assert_array_equal(scale, sc.numpy().reshape(-1))
    order = fe.bf16_channel_order(c).numpy()
    want = w1.numpy().transpose(2, 1, 0)[:, :, order]
    np.testing.assert_array_equal(bf16_values(w1t).reshape(3, c, c), bf16_round(want))
    with pytest.raises(ValueError, match="C % 16"):
        fe.extractor_front_kernel(wav, w0[:24], gamma[:24], beta[:24], w1[:24, :24])


def test_layer_wrapper_sends_bf16_to_the_bf16_entry(monkeypatch):
    """A bf16 hidden state reaches ``qvc_transformer_layer_bf16`` with the
    weight matrices in bf16, the vectors in float32, bf16 scratch but the
    float32 sums, the wgmma core's plans (BN, splits, k_chunk) and the bf16
    attention's (rows, bn, stages); float32 still takes the float32 entry on
    its own plans (splits, k_chunk)."""
    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.ops import fused_transformer as ft

    layer = TransformerLayer(768, 12, 3072)
    with torch.no_grad():
        for i, p in enumerate(layer.parameters()):
            p.fill_(0.01 * (i + 1))

    def grab(*args):
        m = args[20] * args[21]
        return (_read(args[1], 4, ctypes.c_uint16), _read(args[2], 4, ctypes.c_float),
                args[20:25], args[26:-1], m)

    calls = _fake(monkeypatch, ft, {"qvc_transformer_layer_bf16": grab,
                                    "qvc_transformer_layer": grab})
    monkeypatch.setattr(ft, "device_sms", lambda index: 132)
    for dtype, entry in ((torch.bfloat16, "qvc_transformer_layer_bf16"),
                         (torch.float32, "qvc_transformer_layer")):
        x = torch.zeros(2, 37, 768, dtype=dtype)
        before = (ft.STATS.launches, ft.BF16_STATS.launches)
        with torch.no_grad():
            out = ft.transformer_layer_kernel(x, layer)
        assert out.dtype == dtype and out.shape == x.shape
        name, _, (w_in, b_in, dims, plans, m) = calls[-1]
        assert name == entry and dims == (2, 37, 768, 12, 3072)
        if dtype == torch.bfloat16:
            want = tuple(v for p in ft.wgmma_layer_plans(m, 768, 3072, 132)
                         for v in (p.bn, p.splits, p.k_chunk))
            want += ft.bf16_attention_plan(2, 12, 37, 64, 132).c_args()
        else:
            want = tuple(v for p in ft.layer_plans(m, 768, 3072, 132)
                         for v in (p.splits, p.k_chunk))
        assert plans == want
        np.testing.assert_allclose(b_in, 0.02, rtol=1e-6)   # the float32 in_proj bias
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(bf16_values(w_in), bf16_round(np.full(4, 0.01)))
            assert (ft.STATS.launches, ft.BF16_STATS.launches) == (before[0], before[1] + 1)
        else:
            assert (ft.STATS.launches, ft.BF16_STATS.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("layout", ["headed", "aligned"])
def test_attention_wrappers_send_bf16_to_the_bf16_entries(monkeypatch, layout):
    """K10's bf16 (B, H, T, D) views and K9's bf16 128-lane heads reach
    ``qvc_attention_headed_bf16`` and ``qvc_attention_packed_bf16`` (D = 128)
    with the float32 entries' arguments and count apart by dtype."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    calls = _fake(monkeypatch, fa, {n: (lambda *a: a) for n in (
        "qvc_attention_headed", "qvc_attention_headed_bf16", "qvc_attention_packed",
        "qvc_attention_packed_bf16")})
    for dtype in (torch.bfloat16, torch.float32):
        suffix = "_bf16" if dtype == torch.bfloat16 else ""
        if layout == "headed":
            q, k, v = torch.zeros(2, 37, 3, 4, 32, dtype=dtype).unbind(2)
            q, k, v = (z.transpose(1, 2) for z in (q, k, v))
            stats = fa.HEADED_BF16_STATS if suffix else fa.HEADED_STATS
            before = stats.launches
            out = fa.attention_kernel(q, k, v, 0.125)
            assert out.shape == (2, 4, 37, 32) and out.is_contiguous()
            name, args, _ = calls[-1]
            assert name == "qvc_attention_headed" + suffix
            assert args[4:8] == (2, 4, 37, 32) and args[8:11] == (3 * 4 * 37 * 32, 32, 3 * 4 * 32)
        else:
            q = k = v = torch.zeros(2, 37, 3 * 128, dtype=dtype)
            stats = fa.ALIGNED_BF16_STATS if suffix else fa.ALIGNED_STATS
            before = stats.launches
            out = fa.attention_packed_aligned_kernel(q, k, v, 3, 0.125)
            assert out.shape == q.shape
            name, args, _ = calls[-1]
            assert name == "qvc_attention_packed" + suffix
            assert args[4:8] == (2, 37, 3, 128)
        assert out.dtype == dtype and stats.launches == before + 1
