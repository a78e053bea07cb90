"""PyTorch port, kernel K2's bf16 mode on the CPU (no JAX): numpy models of
the two bf16 bodies of ``csrc/fused_attention_bf16.cuh`` against float64
attention; ``bf16_attention_plan``'s cover of every path shape and its
waves; the dtypes each attention, conv and layer dispatcher takes; the
wrappers handing bf16 q/k/v and their plan to the bf16 entries; the build
listing the header.

The models follow the bodies step by step: q, k and v hold bf16 values,
the scores are float32 sums of exact bf16 products (mma.sync m16n8k16 or
wgmma m64nBNk16 with float32 accumulation), the online softmax runs over
key tiles in float32 (log2 units: 64 keys for the mma.sync body, the
plan's BN for the wgmma one, which takes them through its ring of stages
and 64-row warpgroups), the unnormalised p of each tile is rounded to bf16
for the PV product, which accumulates in float32, and the output is divided
by the row sum and rounded to bf16 once. Tolerances (PERF.md section 2):
its max error against float64 attention of the same bf16 inputs at most
1.5x the plain version's (which rounds the scores and the normalised p to
bf16, as the JAX package's off-TPU path does), and max |model - plain| <=
8e-3 max|v|.
"""

import ctypes

import numpy as np
import pytest
import torch

from torch_port_support import bf16_tensor, bf16_values

from quickvc_tpu_torch.utils import bf16

BN = 64   # keys a tile of the body


def bf16_round(x: np.ndarray) -> np.ndarray:
    return bf16_values(bf16.to_bits(np.asarray(x, np.float32)))


def body_model(q: np.ndarray, k: np.ndarray, v: np.ndarray, scale: float,
               bn: int = BN) -> np.ndarray:
    """(rows, D) queries and (T, D) keys and values of one head, bf16-valued
    float32 -> the body's (rows, D) output, over key tiles of ``bn``."""
    t, d = q.shape[0], q.shape[1]
    m = np.full((t, 1), -np.inf, np.float32)
    l = np.zeros((t, 1), np.float32)
    acc = np.zeros((t, d), np.float32)
    sl2 = np.float32(scale * 1.4426950408889634)
    for n0 in range(0, k.shape[0], bn):
        s = (q @ k[n0:n0 + bn].T).astype(np.float32) * sl2
        mn = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp2(m - mn).astype(np.float32)
        p = np.exp2(s - mn).astype(np.float32)
        l = l * alpha + p.sum(axis=1, keepdims=True, dtype=np.float32)
        acc = acc * alpha + (bf16_round(p) @ v[n0:n0 + bn]).astype(np.float32)
        m = mn
    return bf16_round(acc / l)


def attention64(q, k, v, scale):
    s = q.astype(np.float64) @ k.astype(np.float64).T * scale
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v.astype(np.float64)


@pytest.mark.parametrize("t_len", [50, 250, 333])
def test_bf16_body_model_against_float64(t_len):
    """Two heads of 64 lanes, packed (1, T, 128) as K2 takes them; T = 250 is
    the conversion's HuBERT length, 50 and 333 leave ragged key tiles."""
    from quickvc_tpu_torch.ops.fused_attention import attention_packed_reference

    rng = np.random.default_rng(t_len)
    h, d = 2, 64
    q, k, v = (bf16_round(rng.standard_normal((t_len, h * d))) for _ in range(3))
    scale = d ** -0.5
    plain = attention_packed_reference(*(bf16_tensor(bf16.to_bits(z))[None] for z in (q, k, v)),
                                       h, scale)
    assert plain.dtype == torch.bfloat16
    plain = plain[0].float().numpy()
    for head in range(h):
        cols = slice(head * d, (head + 1) * d)
        ours = body_model(q[:, cols], k[:, cols], v[:, cols], scale)
        exact = attention64(q[:, cols], k[:, cols], v[:, cols], scale)
        err_ours = np.abs(ours - exact).max()
        err_plain = np.abs(plain[:, cols] - exact).max()
        assert err_ours <= 1.5 * err_plain, (err_ours, err_plain)
        assert np.abs(ours - plain[:, cols]).max() <= 8e-3 * np.abs(v[:, cols]).max()


def wgmma_body_model(q: np.ndarray, k: np.ndarray, v: np.ndarray, scale: float,
                     plan) -> np.ndarray:
    """The TMA + wgmma body on one (batch, head), CTA by CTA from the plan:
    each CTA's query rows in 64-row warpgroups, the producer filling ring
    stage it % stages with key tile it (rows past T zeros, as TMA fills
    them) only once every warpgroup has released the tile it held, each
    warpgroup's online softmax over the plan's BN-key tiles from the stage
    it waits for. Each query row is computed exactly once."""
    t, d = q.shape
    out = np.full((t, d), np.nan, np.float32)
    n_tiles = -(-t // plan.bn)
    kp, vp = (np.concatenate([z, np.zeros((n_tiles * plan.bn - t, d), np.float32)])
              for z in (k, v))
    for rows in plan.tiles(t):
        groups = [range(r, min(r + 64, rows.stop)) for r in range(rows.start, rows.stop, 64)]
        assert len(groups) <= plan.rows // 64
        ring = [None] * plan.stages          # the tile each stage holds
        released = [len(groups)] * plan.stages
        for it in range(n_tiles):
            st = it % plan.stages
            assert released[st] == len(groups)   # the "empty" barrier's arrivals
            ring[st], released[st] = it, 0
            for _ in groups:                     # each warpgroup waits on "full", uses, releases
                assert ring[st] == it
                released[st] += 1
        for g in groups:
            assert np.isnan(out[g.start:g.stop]).all()
            sl = slice(g.start, g.stop)
            # keys past T: masked scores in the body, zeros from TMA here
            part = body_model(q[sl], kp[:t], vp[:t], scale, plan.bn)
            out[sl] = part
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("t_len", [50, 68, 250, 333])
@pytest.mark.parametrize("d,batch", [(64, 8), (64, 64), (128, 8)])
def test_wgmma_body_model_against_float64(t_len, d, batch):
    """The wgmma body of each compiled configuration the plan picks (64 and
    128 rows at D = 64, 32-key tiles at D = 128), two heads packed as K2
    takes them, against float64 attention by the rules of the mma.sync
    body's model."""
    from quickvc_tpu_torch.ops.fused_attention import (attention_packed_reference,
                                                        bf16_attention_plan)

    rng = np.random.default_rng(t_len + d)
    h = 2
    plan = bf16_attention_plan(batch, 12, t_len, d)
    assert plan.body == "wgmma"
    q, k, v = (bf16_round(rng.standard_normal((t_len, h * d))) for _ in range(3))
    scale = d ** -0.5
    plain = attention_packed_reference(*(bf16_tensor(bf16.to_bits(z))[None] for z in (q, k, v)),
                                       h, scale)[0].float().numpy()
    for head in range(h):
        cols = slice(head * d, (head + 1) * d)
        ours = wgmma_body_model(q[:, cols], k[:, cols], v[:, cols], scale, plan)
        exact = attention64(q[:, cols], k[:, cols], v[:, cols], scale)
        err_ours = np.abs(ours - exact).max()
        err_plain = np.abs(plain[:, cols] - exact).max()
        assert err_ours <= 1.5 * err_plain, (err_ours, err_plain)
        assert np.abs(ours - plain[:, cols]).max() <= 8e-3 * np.abs(v[:, cols]).max()


# (batch, heads, T, D) of the path's bf16 attention calls: K9; K2 at the
# conversion, the live wave windows and a ragged T; K10 and its small head
# dim; K8's attention at the encoding batch
PATH_SHAPES = [(8, 12, 250, 128), (8, 12, 250, 64), (64, 12, 68, 64), (64, 12, 80, 64),
               (3, 12, 333, 64), (2, 3, 50, 16), (16, 12, 300, 64)]


@pytest.mark.parametrize("shape", PATH_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_covers_each_row_once_in_whole_waves(shape, sms):
    """Every (batch, head, query row) taken by exactly one CTA; the CTAs
    fill the waves the plan claims (more than waves - 1 of them, at most
    waves), each CTA's shared memory fits an SM as many times as the plan
    puts there; K9, K2 and K10 at (8, 250) launch one wave on 132 SMs."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    b, h, t, d = shape
    plan = fa.bf16_attention_plan(b, h, t, d, sms)
    assert plan.body == ("mma_sync" if d < 64 else "wgmma")
    if plan.body == "wgmma":
        bn, stages, _ = fa.WGMMA_CONFIGS[(d, plan.rows // 64)]
        assert (plan.bn, plan.stages) == (bn, stages)
    seen = np.zeros((b, h, t), int)
    ctas = 0
    for batch in range(b):
        for head in range(h):
            for rows in plan.tiles(t):
                assert 1 <= len(rows) <= plan.rows
                seen[batch, head, rows.start:rows.stop] += 1
                ctas += 1
    assert (seen == 1).all() and ctas == plan.ctas
    slots = plan.per_sm * sms
    assert (plan.waves - 1) * slots < plan.ctas <= plan.waves * slots
    assert plan.per_sm * (plan.smem + fa.CTA_SMEM_RESERVED) <= fa.SM_SMEM
    if sms == 132 and t == 250 and b == 8:
        assert plan.waves == 1


def test_plan_takes_the_mma_sync_body_where_tma_cannot():
    """Views TMA does not take, and head dims 16 and 32, run the mma.sync
    body (the C entries' rows 0); the TMA check wants 16-byte aligned
    pointers and strides in one order for q, k and v."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    assert fa.bf16_attention_plan(8, 12, 250, 64, tma=False).c_args() == (0, 64, 2)
    assert fa.bf16_attention_plan(2, 3, 50, 32).c_args() == (0, 64, 2)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.bf16_attention_plan(1, 1, 8, 48)
    qkv = torch.zeros(2, 37, 3 * 768, dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    views = [(z, (z.stride(0), 64, z.stride(1))) for z in (q, k, v)]
    assert fa._tma_ok(*views)
    odd = qkv[..., 1:1 + 768]
    assert not fa._tma_ok((odd, (odd.stride(0), 64, odd.stride(1))), *views[1:])
    heads = torch.zeros(2, 4, 37, 64, dtype=torch.bfloat16)
    assert not fa._tma_ok((heads, heads.stride()[:3]), *views[1:])   # another stride order


def test_dispatchers_take_the_dtypes_their_kernels_take():
    """K2, K5 and K7-K10 take float32 and bf16 (the plain versions here) and
    answer in the input's dtype; K5 refuses float16; q, k and v of mixed
    dtypes are refused."""
    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.ops import (fused_attention, fused_disc_conv, fused_extractor,
                                       fused_transformer)

    x = torch.randn(1, 8, 64)
    for dtype in (torch.float32, torch.bfloat16):
        z = x.to(dtype)
        assert fused_attention.attention_packed(z, z, z, 1, 0.125).dtype == dtype
    with pytest.raises(TypeError, match="one dtype"):
        fused_attention.attention_packed(x, x.bfloat16(), x, 1, 0.125)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention.attention_packed(x.half(), x.half(), x.half(), 1, 0.125)

    xb = x.bfloat16()
    hb = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    pad = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    layer = TransformerLayer(64, 1, 128)
    with torch.no_grad():
        for p in layer.parameters():
            p.fill_(0.01)
        takes = [fused_attention.attention(hb, hb, hb, 0.25),
                 fused_attention.attention_packed_aligned(pad, pad, pad, 1, 0.125),
                 fused_extractor.extractor_front(
                     torch.zeros(1, 400, dtype=torch.bfloat16), torch.zeros(16, 1, 10),
                     torch.ones(16), torch.zeros(16), torch.zeros(16, 16, 3)),
                 fused_transformer.transformer_layer(xb, layer)]
        takes.append(fused_disc_conv.conv5_lrelu(
            xb, torch.zeros(5, 64, 64, dtype=torch.bfloat16),
            torch.zeros(64, dtype=torch.bfloat16)))
        assert all(z.dtype == torch.bfloat16 for z in takes)
        with pytest.raises(TypeError, match="float32 or bfloat16, got torch.float16"):
            fused_disc_conv.conv5_lrelu(x.half(), torch.zeros(5, 64, 64).half(),
                                        torch.zeros(64).half())
    with pytest.raises(TypeError, match="one dtype"):
        fused_attention.attention(hb, hb.float(), hb, 0.25)


def test_wrapper_sends_bf16_to_the_bf16_entry(monkeypatch):
    """bf16 q/k/v (views of one qkv, as HuBERT passes them) reach
    ``qvc_attention_packed_bf16`` with the f32 entry's arguments, come back
    as a bf16 (B, T, H*D) and count in ``BF16_STATS`` only; float32 ones
    still take the float32 entry."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    calls = []

    class FakeLib:
        def qvc_attention_packed(self, *args):
            calls.append(("f32", args))
            return 0

        def qvc_attention_packed_bf16(self, *args):
            calls.append(("bf16", args))
            return 0

    monkeypatch.setattr(fa, "library", lambda: FakeLib())
    monkeypatch.setattr(fa, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fa, "device_sms", lambda index: 132)
    monkeypatch.setattr(fa, "require_cuda",
                        lambda name, *ts, **kw: fa.require_dtype(name, *ts, **kw))
    for dtype, entry in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = torch.zeros(2, 37, 3 * 768, dtype=dtype).chunk(3, dim=-1)
        before = (fa.STATS.launches, fa.BF16_STATS.launches)
        out = fa.attention_packed_kernel(q, k, v, 12, 0.125)
        assert out.dtype == dtype and out.shape == (2, 37, 768)
        name, args = calls[-1]
        assert name == entry
        assert args[4:8] == (2, 37, 12, 64) and args[8:14] == (3 * 768 * 37, 3 * 768) * 3
        assert args[14] == 0.125
        if entry == "bf16":   # the plan: the wgmma body on these aligned views
            assert args[15:18] == fa.bf16_attention_plan(2, 12, 37, 64, 132).c_args()
            assert args[15] in (64, 128) and len(args) == 19
        else:
            assert len(args) == 16
        bumped = (fa.STATS.launches - before[0], fa.BF16_STATS.launches - before[1])
        assert bumped == ((0, 1) if entry == "bf16" else (1, 0))
    # views a value off 16 bytes take the mma.sync body: rows 0
    q, k, v = torch.zeros(2, 37, 3 * 768 + 1, dtype=torch.bfloat16)[..., 1:].chunk(3, dim=-1)
    fa.attention_packed_kernel(q, k, v, 12, 0.125)
    assert calls[-1][1][15:18] == (0, 64, 2)


def test_build_lists_the_bf16_header():
    """The bf16 headers are hashed into the library's name (an edit rebuilds
    it), the sources that use them include them, and each bf16 entry's C
    signature is its float32 entry's, but that the attention entries take
    the bf16 plan's (rows, bn, stages) before the stream, and K8's bf16
    entry a third plan value, the wgmma core's tile width, for each of its
    four GEMMs, then the attention's plan."""
    from quickvc_tpu_torch.ops import _cuda

    assert {"fused_attention_bf16.cuh", "bf16_gemm.cuh", "wgmma_bf16.cuh",
            "tma_wgmma.cuh"} <= set(_cuda.HEADERS)
    for source, headers in (("fused_attention.cu", ["fused_attention_bf16.cuh"]),
                            ("fused_transformer.cu", ["bf16_gemm.cuh", "wgmma_bf16.cuh",
                                                      "fused_attention_bf16.cuh"]),
                            ("fused_extractor.cu", ["bf16_gemm.cuh"])):
        text = (_cuda.CSRC / source).read_text()
        assert all(f'#include "{h}"' in text for h in headers), source
    body = (_cuda.CSRC / "fused_attention_bf16.cuh").read_text()
    assert '#include "bf16_gemm.cuh"' in body and '#include "tma_wgmma.cuh"' in body
    assert _cuda._SIGNATURES["qvc_extractor_front_bf16"] == _cuda._SIGNATURES[
        "qvc_extractor_front"]
    for entry in ("qvc_attention_packed", "qvc_attention_headed"):
        f32, bf = _cuda._SIGNATURES[entry], _cuda._SIGNATURES[entry + "_bf16"]
        assert bf == f32[:-1] + [ctypes.c_int] * 3 + f32[-1:]
    f32, bf = _cuda._SIGNATURES["qvc_transformer_layer"], _cuda._SIGNATURES[
        "qvc_transformer_layer_bf16"]
    assert bf[:26] == f32[:26] and bf[-1] == f32[-1]   # pointers, shapes, scale; stream
    assert (bf[26:-1], f32[26:-1]) == ([ctypes.c_int] * 15, [ctypes.c_int] * 8)
