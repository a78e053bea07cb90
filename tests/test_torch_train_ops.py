"""PyTorch port, training slice, ops: the plain versions of kernels K4 (halo
spectrogram) and K5/K6 (k=5 conv and its gradients), segment slicing, the
differentiable decoder head, and the no-backward guard of the K1/K3
dispatchers, held against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as tests/test_pallas.py
does. Tolerances: spectrogram atol/rtol 2e-4 (the JAX gate), conv forward
and gradients atol 1e-4 / rtol 1e-3 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import TINY_HUBERT, TINY_MODEL, t, tiny_generator


def _pallas_interpret(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


@pytest.mark.parametrize("frames", [7, 40])
def test_wave_to_spec_halo_plain_matches_jax(rng, frames):
    """K4's plain version == JAX wave_to_spec_halo (XLA) and
    wave_to_spec_halo_pallas (interpret mode); no kernel on a CPU tensor."""
    from quickvc_tpu.dsp.stft import wave_to_spec_halo as jax_halo
    from quickvc_tpu.ops.fused_mel import wave_to_spec_halo_pallas
    from quickvc_tpu_torch.ops import fused_mel

    y = rng.standard_normal((2, frames * 320 + 960)).astype(np.float32) * 0.1
    xla = np.asarray(jax_halo(jnp.asarray(y), 1280, 320, 1280))
    pallas = np.asarray(_pallas_interpret(
        wave_to_spec_halo_pallas, jnp.asarray(y), 1280, 320, 1280))
    before = fused_mel.SPEC_STATS.launches
    ours = fused_mel.wave_to_spec_halo(t(y), 1280, 320, 1280).numpy()
    assert fused_mel.SPEC_STATS.launches == before
    assert ours.shape == xla.shape == pallas.shape == (2, frames, 641)
    np.testing.assert_allclose(ours, xla, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours, pallas, atol=2e-4, rtol=2e-4)


def test_conv5_lrelu_plain_matches_jax(rng):
    """K5/K6's plain version: forward and the three gradients against JAX
    conv5_lrelu (Pallas, interpret mode, custom VJP) and conv5_lrelu_reference."""
    from quickvc_tpu.ops.fused_disc_conv import conv5_lrelu as jax_conv5
    from quickvc_tpu.ops.fused_disc_conv import conv5_lrelu_reference as jax_ref
    from quickvc_tpu_torch.ops import fused_disc_conv

    n, rows, c_in, c_out = 2, 21, 128, 128
    x = rng.standard_normal((n, rows, c_in)).astype(np.float32) * 0.3
    k = rng.standard_normal((5, c_in, c_out)).astype(np.float32) * 0.05
    b = rng.standard_normal(c_out).astype(np.float32) * 0.1
    dy = rng.standard_normal((n, rows, c_out)).astype(np.float32)

    def jax_grads(fn):
        def loss(x, k, b):
            return jnp.sum(fn(x, k, b, 0.1) * dy)
        return [np.asarray(fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), 0.1))] + [
            np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
                jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))]

    golden_ref = jax_grads(jax_ref)
    golden_pallas = _pallas_interpret(lambda: jax_grads(jax_conv5))
    inputs = [t(a).requires_grad_() for a in (x, k, b)]
    before = (fused_disc_conv.STATS.launches, fused_disc_conv.DW_STATS.launches)
    y = fused_disc_conv.conv5_lrelu(*inputs, 0.1)
    y.backward(t(dy))
    assert (fused_disc_conv.STATS.launches, fused_disc_conv.DW_STATS.launches) == before
    ours = [y.detach().numpy()] + [a.grad.numpy() for a in inputs]
    for name, o, g_ref, g_pal in zip(("y", "dx", "dw", "db"), ours, golden_ref, golden_pallas):
        np.testing.assert_allclose(o, g_ref, atol=1e-4, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(o, g_pal, atol=1e-4, rtol=1e-3, err_msg=name)


def test_slicing_matches_jax(rng):
    from quickvc_tpu.ops.slicing import slice_segments as jax_slice
    from quickvc_tpu_torch.ops.slicing import rand_slice_segments, slice_segments

    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    ids = np.array([0, 17, 32])
    golden = np.asarray(jax_slice(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(ids), 8))
    ours = slice_segments(t(x), torch.from_numpy(ids), 8)
    np.testing.assert_array_equal(ours.numpy(), golden.transpose(0, 2, 1))
    # random starts follow the +1 convention and the generator
    seg, starts = rand_slice_segments(t(x), 8, torch.Generator().manual_seed(0))
    again = rand_slice_segments(t(x), 8, torch.Generator().manual_seed(0))[1]
    assert torch.equal(starts, again) and int(starts.max()) <= 40 - 8
    np.testing.assert_array_equal(seg.numpy(), slice_segments(t(x), starts, 8).numpy())


def test_decoder_differentiable_head_matches_kernel_path(rng):
    """differentiable=True gives the K3 path's waveform and a gradient to the
    decoder's first layer; the K3 dispatcher refuses a graph."""
    _, _, port = tiny_generator(seed=3)
    m = TINY_MODEL
    z = t(rng.standard_normal((2, m["inter_channels"], 9)).astype(np.float32))
    g = t(rng.standard_normal((2, m["gin_channels"], 1)).astype(np.float32))
    with torch.no_grad():
        plain = port.dec(z, g, differentiable=False)[0]
    wave = port.dec(z, g, differentiable=True)[0]
    np.testing.assert_allclose(wave.detach().numpy(), plain.numpy(), atol=1e-6, rtol=1e-5)
    wave.square().sum().backward()
    assert port.dec.conv_pre.weight_v.grad.abs().sum() > 0
    with pytest.raises(RuntimeError, match="no backward"):
        port.dec(z, g, differentiable=False)


def test_kernel_dispatchers_refuse_a_graph(rng):
    """K1, K2, K3, K7, K8, K9 and K10 have no backward: with grad mode on, an input
    that requires grad raises on the CPU as it would on the card; under
    no_grad it runs. A HuBERT forward with grad raises at its first kernel."""
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.ops import fused_attention, fused_istft, fused_mel

    y = t(rng.standard_normal((1, 6400)).astype(np.float32)).requires_grad_()
    with pytest.raises(RuntimeError, match="wave_to_mel has no backward"):
        fused_mel.wave_to_mel(y, 16000, 1280, 320, 1280, 80)
    lm = t(rng.standard_normal((2, 11, 9)).astype(np.float32)).requires_grad_()
    ph = t(rng.standard_normal((2, 11, 9)).astype(np.float32))
    with pytest.raises(RuntimeError, match="polar_inverse_stft has no backward"):
        fused_istft.polar_inverse_stft(lm, ph, 16, 4)
    q = t(rng.standard_normal((1, 9, 64)).astype(np.float32)).requires_grad_()
    with pytest.raises(RuntimeError, match="attention_packed has no backward"):
        fused_attention.attention_packed(q, q, q, 4, 0.25)
    qa = t(rng.standard_normal((1, 9, 256)).astype(np.float32)).requires_grad_()
    with pytest.raises(RuntimeError, match="attention_packed_aligned has no backward"):
        fused_attention.attention_packed_aligned(qa, qa, qa, 2, 0.25)
    qh = q.detach().reshape(1, 9, 4, 16).transpose(1, 2).requires_grad_()
    with pytest.raises(RuntimeError, match="attention has no backward"):
        fused_attention.attention(qh, qh, qh, 0.25)
    wav = t(rng.standard_normal((1, 4000)).astype(np.float32))
    for front, fused, name in (("faststats", False, "attention_packed"),
                               ("pallas", False, "extractor_front"),
                               ("faststats", True, "transformer_layer")):
        hubert = HubertSoft(front=front, use_fused_layer=fused, **TINY_HUBERT)
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            hubert.units(wav)
    with torch.no_grad():
        assert fused_mel.wave_to_mel(y, 16000, 1280, 320, 1280, 80).shape == (1, 20, 80)
        assert fused_istft.polar_inverse_stft(lm, ph, 16, 4).shape == (2, 40)
        assert fused_attention.attention_packed(q, q, q, 4, 0.25).shape == (1, 9, 64)
        assert fused_attention.attention_packed_aligned(qa, qa, qa, 2, 0.25).shape == (1, 9, 256)
        assert fused_attention.attention(qh, qh, qh, 0.25).shape == (1, 4, 9, 16)
        assert hubert.units(wav).shape == (1, 4000 // 320, TINY_HUBERT["unit_dim"])
