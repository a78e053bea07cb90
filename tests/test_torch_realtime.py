"""PyTorch port, live sessions: ``RealtimeSession`` and ``RealtimeWaveSession``
against the JAX package's, push by push and through ``flush``, at a tiny
config (TINY_MODEL, TINY_HUBERT) with the same weights, noise 0.

Tolerance: every returned block within 1e-4 x its peak (the same windows
through the same layers in float32; measured ~8e-7), 2e-5 absolute between a
batched stream and the same stream alone (the JAX package's own gate).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_support import TINY_MODEL, tiny_generator, tiny_hubert

HOP = 320


def _d_vectors(rng, n):
    g = rng.standard_normal((n, TINY_MODEL["gin_channels"])).astype(np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True)


def _assert_blocks_match(ours, golden):
    assert len(ours) == len(golden)
    for a, b in zip(ours, golden):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).max(initial=0.0) <= 1e-4 * np.abs(b).max(initial=0.0)


@pytest.mark.parametrize("right", [16, 0])
def test_unit_session_matches_jax(rng, right):
    """Two streams, chunk 16, left 32; ``right = 0`` is causal and its flush is empty."""
    from quickvc_tpu.infer import RealtimeSession as JaxSession
    from quickvc_tpu_torch.infer import RealtimeSession

    net, params, port = tiny_generator(seed=21)
    g = _d_vectors(rng, 2)
    unit = rng.standard_normal((2, 80, TINY_MODEL["unit_channels"])).astype(np.float32)
    kw = dict(chunk=16, left=32, right=right)
    sessions = (RealtimeSession(port, g, device="cpu", **kw),
                JaxSession(net, params, jnp.asarray(g), **kw))
    ours, golden = ([s.push(unit[:, i : i + 16]) for i in range(0, 80, 16)] + [s.flush()]
                    for s in sessions)
    _assert_blocks_match(ours, golden)
    assert ours[-1].shape == (2, right * HOP)
    assert np.concatenate(ours, axis=1).shape == (2, (80 + right) * HOP)


def test_wave_session_matches_jax(rng):
    """Wave in, wave out, with the tiny HuBERT-soft in the step."""
    from quickvc_tpu.infer import RealtimeWaveSession as JaxWaveSession
    from quickvc_tpu_torch.infer import RealtimeWaveSession

    net, params, port = tiny_generator(seed=22)
    jax_hubert, h_params, hubert = tiny_hubert("faststats", seed=23)
    g = _d_vectors(rng, 2)
    kw = dict(chunk=8, left=16, right=8)
    sessions = (RealtimeWaveSession(port, g, hubert, device="cpu", **kw),
                JaxWaveSession(net, params, jnp.asarray(g), jax_hubert, {"params": h_params},
                               **kw))
    chunks = [(0.3 * rng.standard_normal((2, 8 * HOP))).astype(np.float32) for _ in range(3)]
    ours, golden = ([s.push(c) for c in chunks] + [s.flush()] for s in sessions)
    _assert_blocks_match(ours, golden)
    assert np.concatenate(ours, axis=1).shape == (2, (3 * 8 + 8) * HOP)


def test_batched_streams_are_independent(rng):
    """N streams in one session == each stream in a session of its own."""
    from quickvc_tpu_torch.infer import RealtimeSession

    _, _, port = tiny_generator(seed=24)
    g = _d_vectors(rng, 3)
    unit = rng.standard_normal((3, 32, TINY_MODEL["unit_channels"])).astype(np.float32)
    kw = dict(chunk=16, left=16, right=8, device="cpu")
    batched = RealtimeSession(port, g, **kw)
    got = np.concatenate([batched.push(unit[:, :16]), batched.push(unit[:, 16:])], axis=1)
    for i in range(3):
        solo = RealtimeSession(port, g[i : i + 1], **kw)
        want = np.concatenate([solo.push(unit[i : i + 1, :16]), solo.push(unit[i : i + 1, 16:])],
                              axis=1)
        np.testing.assert_allclose(got[i], want[0], atol=2e-5)


def test_session_refuses_wrong_blocks_and_devices(rng):
    from quickvc_tpu_torch.infer import RealtimeSession

    _, _, port = tiny_generator(seed=25)
    session = RealtimeSession(port, _d_vectors(rng, 1), chunk=4, left=4, right=4, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        session.push(np.zeros((1, 5, TINY_MODEL["unit_channels"]), np.float32))
    with pytest.raises(ValueError, match="contexts"):
        RealtimeSession(port, _d_vectors(rng, 1), chunk=0, device="cpu")
    if not torch.cuda.is_available():   # the default device is the card, never a fallback
        with pytest.raises(RuntimeError, match="no CUDA card"):
            RealtimeSession(port, _d_vectors(rng, 1))
