"""PyTorch port, kernels K9 and K10 and the templated K2: the plain versions of
the three attention layouts against the JAX package's Pallas bodies.

The JAX ops take their einsum path off the TPU, so each golden value comes
from the Pallas body itself: ``jax.default_backend`` reports "tpu" and the
kernel runs in Pallas's TPU interpret mode. Tolerance atol/rtol 1e-5
(float32, summation order; the JAX body runs its products at HIGHEST).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_port_support import t


@pytest.fixture
def pallas_body(monkeypatch):
    """Call a JAX attention op so that it reaches its pallas_call, in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")

    def run(fn, *args, **kw):
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))

    return run


@pytest.mark.parametrize("shape", [(2, 3, 50, 16), (1, 12, 130, 64)])
def test_headed_plain_matches_pallas(rng, pallas_body, shape):
    """K10: (B, H, T, D) attention; a CPU tensor launches no kernel."""
    from quickvc_tpu.ops.fused_attention import fused_attention
    from quickvc_tpu_torch.ops import fused_attention as port, reset_launch_counts

    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(shape[-1])
    golden = pallas_body(fused_attention, q, k, v, scale=scale)
    reset_launch_counts()
    ours = port.attention(t(q), t(k), t(v), scale).numpy()
    assert port.HEADED_STATS.launches == 0
    assert ours.shape == golden.shape == shape
    np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-5)


def test_packed_aligned_plain_matches_pallas(rng, pallas_body):
    """K9: two heads of true width 64 zero-padded to 128 lanes; the padded
    output lanes are exactly zero."""
    from quickvc_tpu.ops.fused_attention import fused_attention_packed_aligned
    from quickvc_tpu_torch.ops import fused_attention as port, reset_launch_counts

    b, t_len, heads, d, pad = 1, 40, 2, 64, 128
    q, k, v = (np.zeros((b, t_len, heads, pad), np.float32) for _ in range(3))
    for z in (q, k, v):
        z[..., :d] = rng.standard_normal((b, t_len, heads, d))
    q, k, v = (z.reshape(b, t_len, heads * pad) for z in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    golden = pallas_body(fused_attention_packed_aligned, q, k, v, num_heads=heads,
                         scale=scale, head_pad=pad)
    reset_launch_counts()
    ours = port.attention_packed_aligned(t(q), t(k), t(v), heads, scale, pad).numpy()
    assert port.ALIGNED_STATS.launches == 0
    assert ours.shape == golden.shape == q.shape
    np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-5)
    padded = ours.reshape(b, t_len, heads, pad)[..., d:]
    assert not padded.any() and np.abs(ours).max() > 0


@pytest.mark.parametrize("heads,d", [(4, 16), (2, 32), (2, 128)])
def test_packed_other_head_dims_match_pallas(rng, pallas_body, heads, d):
    """K2 at the head dims beside HuBERT's 64 that its templated body compiles."""
    from quickvc_tpu.ops.fused_attention import fused_attention_packed
    from quickvc_tpu_torch.ops import fused_attention as port

    q, k, v = (rng.standard_normal((2, 37, heads * d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    golden = pallas_body(fused_attention_packed, q, k, v, num_heads=heads, scale=scale)
    ours = port.attention_packed(t(q), t(k), t(v), heads, scale).numpy()
    np.testing.assert_allclose(ours, golden, atol=1e-5, rtol=1e-5)


def test_layouts_agree(rng):
    """The three plain versions are one function: packed == headed on the
    transposed views == aligned with the heads padded to 128 lanes."""
    from quickvc_tpu_torch.ops import fused_attention as port

    b, t_len, heads, d = 2, 21, 3, 32
    q, k, v = (t(rng.standard_normal((b, t_len, heads * d)).astype(np.float32))
               for _ in range(3))
    packed = port.attention_packed(q, k, v, heads, 0.2)
    headed = port.attention(*(z.reshape(b, t_len, heads, d).transpose(1, 2) for z in (q, k, v)),
                            0.2)
    np.testing.assert_allclose(headed.transpose(1, 2).reshape(b, t_len, -1).numpy(),
                               packed.numpy(), atol=1e-6, rtol=1e-6)

    def pad(z):
        return np.pad(z.reshape(b, t_len, heads, d).numpy(),
                      [(0, 0), (0, 0), (0, 0), (0, 128 - d)]).reshape(b, t_len, heads * 128)

    aligned = port.attention_packed_aligned(t(pad(q)), t(pad(k)), t(pad(v)), heads, 0.2)
    np.testing.assert_allclose(aligned.numpy(), pad(packed), atol=1e-6, rtol=1e-6)
