"""PyTorch port, kernel K2's bf16 mode on the CPU (no JAX): a numpy model of
the bf16 body of ``csrc/fused_attention_bf16.cuh`` against float64
attention; the dtypes each attention, conv and layer dispatcher takes; the
wrapper handing bf16 q/k/v to the bf16 entry; the build listing the header.

The model follows the body step by step: q, k and v hold bf16 values, the
scores are float32 sums of exact bf16 products (mma.sync m16n8k16 with
float32 accumulation), the online softmax runs over 64-key tiles in float32
(log2 units), the unnormalised p of each tile is rounded to bf16 for the PV
product, which accumulates in float32, and the output is divided by the row
sum and rounded to bf16 once. Tolerances (PERF.md section 2): its max error
against float64 attention of the same bf16 inputs at most 1.5x the plain
version's (which rounds the scores and the normalised p to bf16, as the JAX
package's off-TPU path does), and max |model - plain| <= 8e-3 max|v|.
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


def body_model(q: np.ndarray, k: np.ndarray, v: np.ndarray, scale: float) -> np.ndarray:
    """(T, D) bf16-valued float32 operands of one head -> the body's (T, D) output."""
    t, d = q.shape
    m = np.full((t, 1), -np.inf, np.float32)
    l = np.zeros((t, 1), np.float32)
    acc = np.zeros((t, d), np.float32)
    sl2 = np.float32(scale * 1.4426950408889634)
    for n0 in range(0, t, BN):
        s = (q @ k[n0:n0 + BN].T).astype(np.float32) * sl2
        mn = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp2(m - mn).astype(np.float32)
        p = np.exp2(s - mn).astype(np.float32)
        l = l * alpha + p.sum(axis=1, keepdims=True, dtype=np.float32)
        acc = acc * alpha + (bf16_round(p) @ v[n0:n0 + BN]).astype(np.float32)
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
        bumped = (fa.STATS.launches - before[0], fa.BF16_STATS.launches - before[1])
        assert bumped == ((0, 1) if entry == "bf16" else (1, 0))


def test_build_lists_the_bf16_header():
    """The bf16 headers are hashed into the library's name (an edit rebuilds
    it), the sources that use them include them, and each bf16 entry's C
    signature is its float32 entry's, but that K8's bf16 entry takes a third
    plan value, the wgmma core's tile width, for each of its four GEMMs."""
    from quickvc_tpu_torch.ops import _cuda

    assert {"fused_attention_bf16.cuh", "bf16_gemm.cuh", "wgmma_bf16.cuh"} <= set(_cuda.HEADERS)
    for source, headers in (("fused_attention.cu", ["fused_attention_bf16.cuh"]),
                            ("fused_transformer.cu", ["bf16_gemm.cuh", "wgmma_bf16.cuh",
                                                      "fused_attention_bf16.cuh"]),
                            ("fused_extractor.cu", ["bf16_gemm.cuh"])):
        text = (_cuda.CSRC / source).read_text()
        assert all(f'#include "{h}"' in text for h in headers), source
    assert '#include "bf16_gemm.cuh"' in (_cuda.CSRC / "fused_attention_bf16.cuh").read_text()
    for entry in ("qvc_attention_packed", "qvc_attention_headed", "qvc_extractor_front"):
        assert _cuda._SIGNATURES[entry + "_bf16"] == _cuda._SIGNATURES[entry]
    f32, bf = _cuda._SIGNATURES["qvc_transformer_layer"], _cuda._SIGNATURES[
        "qvc_transformer_layer_bf16"]
    assert bf[:26] == f32[:26] and bf[-1] == f32[-1]   # pointers, shapes, scale; stream
    assert (bf[26:-1], f32[26:-1]) == ([ctypes.c_int] * 12, [ctypes.c_int] * 8)
