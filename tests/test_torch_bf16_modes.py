"""PyTorch port, the bf16 modes of kernels K7, K8, K9 and K10 on the CPU: each
plain version on bf16 inputs against the JAX package's Pallas kernel on the
same bf16 inputs, and the tiny HuBERT-soft with the ``pallas`` front and the
fused layer on a bf16 wave against the JAX one with ``front_mode="pallas"``
and ``use_pallas_layer=True``.

The JAX kernels run in Pallas's TPU interpret mode with
``jax.default_backend`` reporting "tpu": off the TPU the JAX HuBERT and the
attention ops take their XLA paths (``quickvc_tpu/models/hubert.py:100-101,
209-210``), which round elsewhere. The tolerance is the bf16 error the JAX
kernel itself shows against its float32 mode on the same (unrounded)
inputs (PERF.md section 2): ``max|port - jax_bf16| <= max(2 max|jax_bf16 -
jax_f32|, 1e-2 peak)``, peak the largest |jax_f32|; each assert prints its
ratio to that bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import TINY_HUBERT, t, tiny_hubert


@pytest.fixture
def pallas_tpu(monkeypatch):
    """Run a JAX function so that it reaches its pallas_calls, in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")

    def run(fn, *args, **kw):
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn(*args, **kw), np.float32)

    return run


def check_bf16(ours: torch.Tensor, ref: np.ndarray, ref32: np.ndarray, what: str) -> None:
    """``ours`` (bf16) against the JAX bf16 result, bounded by the JAX bf16 error."""
    assert ours.dtype == torch.bfloat16, what
    ours = ours.float().numpy()
    assert ours.shape == ref.shape == ref32.shape, what
    err = float(np.abs(ours - ref).max())
    bound = max(2 * float(np.abs(ref - ref32).max()), 1e-2 * float(np.abs(ref32).max()))
    assert err <= bound, f"{what}: max|port - jax| = {err:.3g}, {err / bound:.3f} of {bound:.3g}"


def bf16(x: np.ndarray) -> jax.Array:
    return jnp.asarray(x).astype(jnp.bfloat16)


def test_extractor_front_bf16_matches_pallas(rng, pallas_tpu):
    """K7 at 32 channels, n1 = 807 rows (ragged against the JAX kernel's 1024
    and the CUDA kernel's 64); a CPU tensor launches no kernel."""
    from quickvc_tpu.ops.fused_extractor import fused_extractor_front
    from quickvc_tpu_torch.ops import fused_extractor

    c, t_len = TINY_HUBERT["extractor_channels"], 8083
    wav = rng.standard_normal((2, t_len)).astype(np.float32) * 0.3
    w0 = rng.standard_normal((10, 1, c)).astype(np.float32) * 0.3      # JAX (k, in, out)
    gamma = 1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)
    beta = 0.1 * rng.standard_normal(c).astype(np.float32)
    w1 = (rng.standard_normal((3, c, c)) / np.sqrt(3 * c)).astype(np.float32)
    weights = [jnp.asarray(a) for a in (w0, gamma, beta, w1)]
    ref = pallas_tpu(fused_extractor_front, bf16(wav), *weights)
    ref32 = pallas_tpu(fused_extractor_front, jnp.asarray(wav), *weights)
    before = fused_extractor.BF16_STATS.launches
    ours = fused_extractor.extractor_front(
        t(wav).bfloat16(), t(w0.transpose(2, 1, 0)), t(gamma), t(beta), t(w1.transpose(2, 1, 0)))
    assert fused_extractor.BF16_STATS.launches == before
    assert ours.shape == (2, fused_extractor.front_rows(t_len), c)
    check_bf16(ours, ref, ref32, "K7 bf16")


def test_transformer_layer_bf16_matches_pallas(rng, pallas_tpu):
    """K8 at 64-d x 4 heads, T = 70: the JAX kernel pads to 128 rows and masks
    the padded keys."""
    from quickvc_tpu.ops.fused_transformer import fused_transformer_layer
    from quickvc_tpu_torch.ops import fused_transformer

    _, params, port = tiny_hubert("faststats", seed=7, fused_layer=True)
    layer = port.encoder.layers[0]
    x = rng.standard_normal((2, 70, TINY_HUBERT["embed_dim"])).astype(np.float32) * 0.5
    heads = TINY_HUBERT["num_heads"]
    ref = pallas_tpu(fused_transformer_layer, bf16(x), params["layer_0"], heads)
    ref32 = pallas_tpu(fused_transformer_layer, jnp.asarray(x), params["layer_0"], heads)
    before = fused_transformer.BF16_STATS.launches
    with torch.no_grad():
        ours = layer(t(x).bfloat16())
    assert fused_transformer.BF16_STATS.launches == before
    check_bf16(ours, ref, ref32, "K8 bf16")


@pytest.mark.parametrize("shape", [(2, 3, 50, 16), (1, 12, 130, 64)])
def test_headed_attention_bf16_matches_pallas(rng, pallas_tpu, shape):
    """K10 on bf16 (B, H, T, D)."""
    from quickvc_tpu.ops.fused_attention import fused_attention
    from quickvc_tpu_torch.ops import fused_attention as port

    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(shape[-1])
    ref = pallas_tpu(fused_attention, *(bf16(z) for z in (q, k, v)), scale=scale)
    ref32 = pallas_tpu(fused_attention, *(jnp.asarray(z) for z in (q, k, v)), scale=scale)
    before = port.HEADED_BF16_STATS.launches
    ours = port.attention(*(t(z).bfloat16() for z in (q, k, v)), scale)
    assert port.HEADED_BF16_STATS.launches == before
    check_bf16(ours, ref, ref32, f"K10 bf16 {shape}")


def test_packed_aligned_bf16_matches_pallas(rng, pallas_tpu):
    """K9 on bf16 heads of 64 true lanes padded to 128; padded lanes exactly zero."""
    from quickvc_tpu.ops.fused_attention import fused_attention_packed_aligned
    from quickvc_tpu_torch.ops import fused_attention as port

    b, t_len, heads, d, pad = 1, 40, 2, 64, 128
    q, k, v = (np.zeros((b, t_len, heads, pad), np.float32) for _ in range(3))
    for z in (q, k, v):
        z[..., :d] = rng.standard_normal((b, t_len, heads, d))
    q, k, v = (z.reshape(b, t_len, heads * pad) for z in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    kw = dict(num_heads=heads, scale=scale, head_pad=pad)
    ref = pallas_tpu(fused_attention_packed_aligned, *(bf16(z) for z in (q, k, v)), **kw)
    ref32 = pallas_tpu(fused_attention_packed_aligned, *(jnp.asarray(z) for z in (q, k, v)), **kw)
    before = port.ALIGNED_BF16_STATS.launches
    ours = port.attention_packed_aligned(*(t(z).bfloat16() for z in (q, k, v)), heads, scale, pad)
    assert port.ALIGNED_BF16_STATS.launches == before
    check_bf16(ours, ref, ref32, "K9 bf16")
    assert not ours.reshape(b, t_len, heads, pad)[..., d:].float().any()


def test_pallas_hubert_bf16_units_match_jax(rng, pallas_tpu):
    """The tiny HuBERT with the ``pallas`` front (K7) and every layer fused
    (K8) on a bf16 wave; the units come out bf16."""
    from quickvc_tpu.models.hubert import HubertSoft as JaxHubert

    jnet, params, port = tiny_hubert("pallas", seed=11, fused_layer=True)
    wav = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)

    def units(w):
        return jax.jit(lambda p, x: jnet.apply({"params": p}, x, method=JaxHubert.units))(
            params, w)

    ref, ref32 = pallas_tpu(units, bf16(wav)), pallas_tpu(units, jnp.asarray(wav))
    with torch.no_grad():
        ours = port.units(t(wav).bfloat16())
    check_bf16(ours, ref, ref32, "HuBERT units bf16")
