"""PyTorch port, generator modules against the JAX package at a tiny config.

One seeded flax parameter tree crosses into the port's SynthesizerTrn
through ``generator_state_dict_from_jax``; each submodule is then held
against its flax counterpart on the same numpy inputs, in float32:
WaveNet, the flow in both directions, CondNormalWN at noise 0, the speaker
encoder with window averaging, the multistream decoder and ``infer``.
Tolerances: atol 1e-4 / rtol 1e-3; waveforms max-abs <= 1e-3 x max|ref|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import TINY_MODEL, t, tiny_generator


@pytest.fixture(scope="module")
def gen():
    return tiny_generator(seed=0)


def _close(ours: torch.Tensor, golden, atol=1e-4, rtol=1e-3):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(golden), atol=atol, rtol=rtol)


def _wave_close(ours: np.ndarray, golden: np.ndarray):
    assert ours.shape == golden.shape
    assert np.abs(ours - golden).max() <= 1e-3 * np.abs(golden).max()


def test_wavenet_matches_jax(gen, rng):
    from quickvc_tpu.models.modules import WaveNet

    _, params, port = gen
    h = TINY_MODEL["hidden_channels"]
    x = rng.standard_normal((2, 19, h)).astype(np.float32)
    g = rng.standard_normal((2, 1, TINY_MODEL["gin_channels"])).astype(np.float32)
    # conditioned: the first flow's WaveNet; unconditioned: the prior's
    jwn = WaveNet(h, 5, TINY_MODEL["flow_wn_layers"], TINY_MODEL["gin_channels"])
    golden = jwn.apply({"params": params["flow"]["flow_0"]["enc"]}, jnp.asarray(x), jnp.asarray(g))
    with torch.no_grad():
        _close(port.flow.flows[0].enc(t(x.transpose(0, 2, 1)), t(g.transpose(0, 2, 1))),
               np.asarray(golden).transpose(0, 2, 1))
    jwn = WaveNet(h, 5, TINY_MODEL["enc_wn_layers"], 0)
    golden = jwn.apply({"params": params["enc_p"]["enc"]}, jnp.asarray(x))
    with torch.no_grad():
        _close(port.enc_p.enc(t(x.transpose(0, 2, 1))), np.asarray(golden).transpose(0, 2, 1))


@pytest.mark.parametrize("reverse", [False, True])
def test_flow_matches_jax(gen, rng, reverse):
    from quickvc_tpu.models.modules import ResidualCouplingBlock

    _, params, port = gen
    m = TINY_MODEL
    x = rng.standard_normal((2, 23, m["inter_channels"])).astype(np.float32)
    g = rng.standard_normal((2, 1, m["gin_channels"])).astype(np.float32)
    jflow = ResidualCouplingBlock(m["inter_channels"], m["hidden_channels"], 5,
                                  m["flow_wn_layers"], m["n_flows"], m["gin_channels"])
    golden = jflow.apply({"params": params["flow"]}, jnp.asarray(x), jnp.asarray(g),
                         reverse=reverse)
    xc, gc = t(x.transpose(0, 2, 1)), t(g.transpose(0, 2, 1))
    with torch.no_grad():
        ours = port.flow(xc, gc, reverse=reverse)
        _close(ours, np.asarray(golden).transpose(0, 2, 1))
        _close(port.flow(ours, gc, reverse=not reverse), x.transpose(0, 2, 1))


def test_cond_normal_wn_matches_jax_at_zero_noise(gen, rng):
    from quickvc_tpu.models.modules import CondNormalWN

    _, params, port = gen
    m = TINY_MODEL
    unit = rng.standard_normal((2, 17, m["unit_channels"])).astype(np.float32)
    jenc = CondNormalWN(m["inter_channels"], m["hidden_channels"], 5, m["enc_wn_layers"], 0)
    z, mu, logs = jenc.apply({"params": params["enc_p"]}, jnp.asarray(unit), noise_scale=0.0)
    with torch.no_grad():
        oz, omu, ologs = port.enc_p(t(unit.transpose(0, 2, 1)), noise_scale=0.0)
        for ours, golden in ((oz, z), (omu, mu), (ologs, logs)):
            _close(ours, np.asarray(golden).transpose(0, 2, 1))
        # noise draws come from the generator it is given
        a = port.enc_p(t(unit.transpose(0, 2, 1)), None, 1.0, torch.Generator().manual_seed(3))[0]
        b = port.enc_p(t(unit.transpose(0, 2, 1)), None, 1.0, torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b) and not torch.equal(a, oz)


@pytest.mark.parametrize("frames", [100, 300])
def test_speaker_embedding_matches_jax(gen, rng, frames):
    """d-vector of one window (<= 128 frames) and the mean over sliding windows."""
    from quickvc_tpu.models.encoders import embed_utterance_batch
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
    from quickvc_tpu_torch.models.encoders import embed_utterance

    net, params, port = gen
    mel = rng.standard_normal((1, frames, 80)).astype(np.float32)
    golden = embed_utterance_batch(
        lambda p, m: net.apply({"params": p}, m, method=JaxSynth.embed_speaker),
        params, jnp.asarray(mel))
    with torch.no_grad():
        _close(embed_utterance(port.enc_spk, t(mel)), golden)


def test_multistream_decoder_matches_jax(gen, rng):
    from quickvc_tpu.config import ModelConfig
    from quickvc_tpu.models.decoders import build_decoder

    _, params, port = gen
    m = TINY_MODEL
    z = rng.standard_normal((2, 13, m["inter_channels"])).astype(np.float32)
    g = rng.standard_normal((2, 1, m["gin_channels"])).astype(np.float32)
    dec = build_decoder(ModelConfig(**m))
    wave, streams = jax.jit(lambda p, z, g: dec.apply({"params": p}, z, g))(
        params["dec"], jnp.asarray(z), jnp.asarray(g))
    with torch.no_grad():
        owave, ostreams = port.dec(t(z.transpose(0, 2, 1)), t(g.transpose(0, 2, 1)),
                                   differentiable=False)
    assert owave.shape == (2, 1, 13 * 320)
    _wave_close(owave[:, 0].numpy(), np.asarray(wave)[..., 0])
    _wave_close(ostreams.numpy(), np.asarray(streams).transpose(0, 2, 1))


def test_infer_matches_jax(gen, rng):
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth

    net, params, port = gen
    unit = rng.standard_normal((2, 30, TINY_MODEL["unit_channels"])).astype(np.float32)
    g = rng.standard_normal((2, TINY_MODEL["gin_channels"])).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    infer = jax.jit(lambda p, u, gv: net.apply({"params": p}, u, gv, 0.0,
                                                method=JaxSynth.infer))
    golden = np.asarray(infer(params, jnp.asarray(unit), jnp.asarray(g)))[..., 0]
    with torch.no_grad():
        ours = port.infer(t(unit.transpose(0, 2, 1)), t(g), noise_scale=0.0)
    assert ours.shape == (2, 1, 30 * 320)
    _wave_close(ours[:, 0].numpy(), golden)


def test_reference_checkpoint_loads_strictly(gen, tmp_path):
    """A reference-layout G_*.pth (the JAX package's own exporter, plus the
    reference decoder's iSTFT window buffer) loads strictly and equals the
    port's mapping of the same parameters."""
    from quickvc_tpu.config import ModelConfig as JaxModelConfig
    from quickvc_tpu.utils.torch_export import export_generator, save_reference_checkpoint
    from quickvc_tpu_torch.config import ModelConfig
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import load_generator

    _, params, port = gen
    sd = export_generator(params, JaxModelConfig(**TINY_MODEL))
    sd["dec.stft.window"] = torch.hann_window(16).numpy()
    path = str(tmp_path / "G_0.pth")
    save_reference_checkpoint(path, sd, iteration=0, learning_rate=2e-4)
    fresh = SynthesizerTrn(33, 8, ModelConfig(**TINY_MODEL))
    load_generator(path, fresh)
    expected = port.state_dict()
    assert fresh.state_dict().keys() == expected.keys()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, expected[k]), k
