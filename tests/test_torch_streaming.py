"""PyTorch port, streaming-chunk inference: ``streaming_infer`` against the JAX
package's at a tiny config, noise 0, and the CLI's context default against
the full-width receptive field.

Tolerance: the whole output within 1e-4 x its peak (the same windows through
the same layers in float32; measured ~7e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_support import TINY_MODEL, t, tiny_generator


@pytest.mark.parametrize("frames,chunk,context", [(200, 64, 48), (77, 32, 16)])
def test_streaming_matches_jax(rng, frames, chunk, context):
    from quickvc_tpu.infer import streaming_infer as jax_streaming_infer
    from quickvc_tpu_torch.infer import streaming_infer
    from quickvc_tpu_torch.ops import fused_istft

    net, params, port = tiny_generator(seed=11)
    unit = rng.standard_normal((2, frames, TINY_MODEL["unit_channels"])).astype(np.float32)
    g = rng.standard_normal((2, TINY_MODEL["gin_channels"])).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    golden = np.asarray(jax_streaming_infer(net, params, jnp.asarray(unit), jnp.asarray(g),
                                            hop_length=320, chunk=chunk, context=context))
    before = fused_istft.STATS.launches
    with torch.no_grad():
        ours = streaming_infer(port, t(unit.transpose(0, 2, 1)), t(g), hop_length=320,
                               chunk=chunk, context=context).numpy()
    assert fused_istft.STATS.launches == before   # CPU tensors: the plain head
    assert ours.shape == golden.shape == (2, frames * 320)
    assert np.abs(ours - golden).max() <= 1e-4 * np.abs(golden).max()


def test_streaming_interior_matches_batch_infer(rng):
    """Away from the utterance edges, chunked synthesis is the batch path's."""
    from quickvc_tpu_torch.infer import streaming_infer

    _, _, port = tiny_generator(seed=12)
    frames, edge = 150, 32
    unit = t(rng.standard_normal((1, TINY_MODEL["unit_channels"], frames)).astype(np.float32))
    g = t(rng.standard_normal((1, TINY_MODEL["gin_channels"])).astype(np.float32))
    with torch.no_grad():
        batch = port.infer(unit, g, noise_scale=0.0)[:, 0].numpy()
        chunked = streaming_infer(port, unit, g, chunk=40, context=32).numpy()
    a, b = (x[:, edge * 320 : -edge * 320] for x in (batch, chunked))
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_cli_context_covers_full_width_receptive_field():
    """``--context-frames`` defaults to at least the full-width model's
    receptive field per side, or chunk interiors diverge from the batch path
    (the JAX package's tests/test_streaming.py holds its CLI to the same)."""
    from quickvc_tpu_torch.config import ModelConfig
    from quickvc_tpu_torch.convert import parse_args

    mc = ModelConfig()
    # enc_p's WaveNet (k=5, dilation 1) +-2 a layer, each flow coupling's
    # likewise, couplings in sequence; the decoder ~+-12 frames
    rf = 2 * mc.enc_wn_layers + 2 * mc.n_flows * mc.flow_wn_layers + 12
    args = parse_args([])
    assert args.context_frames >= rf, (args.context_frames, rf)
    assert (args.chunk_frames, args.context_frames, args.streaming) == (96, 96, False)
