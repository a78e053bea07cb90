"""PyTorch port, kernel K2: packed attention's plain version against the JAX
package's ``fused_attention_packed`` (its off-TPU einsum path), and the
wrapper's routing. Tolerance atol 1e-4 / rtol 1e-3 (float32, summation order).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from torch_port_support import t


@pytest.mark.parametrize("b,t_len,heads,d", [(2, 37, 4, 16), (1, 130, 12, 64)])
def test_attention_plain_matches_jax(rng, b, t_len, heads, d):
    from quickvc_tpu.ops.fused_attention import fused_attention_packed
    from quickvc_tpu_torch.ops import fused_attention, reset_launch_counts

    q, k, v = (rng.standard_normal((b, t_len, heads * d)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    golden = np.asarray(fused_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), heads, scale))
    reset_launch_counts()
    ours = fused_attention.attention_packed(t(q), t(k), t(v), heads, scale).numpy()
    assert fused_attention.STATS.launches == 0  # CPU tensor: plain path, no kernel
    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)


def test_attention_reads_qkv_views(rng):
    """The HuBERT layer passes chunks of the fused qkv projection (row stride
    3*H*D); the result equals that on contiguous copies."""
    from quickvc_tpu_torch.ops.fused_attention import attention_packed

    qkv = t(rng.standard_normal((2, 21, 3 * 64)).astype(np.float32))
    q, k, v = qkv.chunk(3, dim=-1)
    assert not q.is_contiguous() and q.stride(-1) == 1
    np.testing.assert_array_equal(
        attention_packed(q, k, v, 4, 0.25).numpy(),
        attention_packed(q.contiguous(), k.contiguous(), v.contiguous(), 4, 0.25).numpy())
