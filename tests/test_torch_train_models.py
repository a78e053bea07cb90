"""PyTorch port, training slice, models and losses: the multi-period
discriminator (logits and feature maps, paired and apart), its opt-in K5
path, the four losses and the generator's training forward, held against
the JAX package on the CPU at width 0.25 and the tiny generator.

Tolerances: atol 1e-4 / rtol 1e-3 (float32 convolutions summed in another
order); losses rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import TINY_MODEL, random_params, t, tiny_generator

WIDTH = 0.25
T = 2560


@pytest.fixture(scope="module")
def mpd():
    """(JAX MPD, numpy params, port MPD) at width 0.25, same weights."""
    from quickvc_tpu.models.discriminators import MultiPeriodDiscriminator as JaxMPD
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.utils.weights import discriminator_state_dict_from_jax

    net = JaxMPD(width=WIDTH)
    wave = jnp.zeros((1, T, 1))
    params = random_params(net, 4, jax.random.PRNGKey(0), wave, wave, scale=0.2)
    port = MultiPeriodDiscriminator(width=WIDTH)
    port.load_state_dict(discriminator_state_dict_from_jax(params), strict=True)
    return net, params, port


@pytest.fixture(scope="module")
def waves():
    rng = np.random.default_rng(11)
    return [(rng.standard_normal((2, T)) * 0.3).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_outputs(mpd, waves):
    net, params, _ = mpd
    y, y_hat = (jnp.asarray(w[..., None]) for w in waves)
    fwd = jax.jit(lambda p, a, b: net.apply({"params": p}, a, b, pair=True))
    return jax.device_get(fwd(params, y, y_hat))


def _fmap_to_jax_layout(f: torch.Tensor) -> np.ndarray:
    """Port fmaps (B, C, T) or (B, C, H, W) -> the JAX package's channels-last."""
    f = f.detach().numpy()
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("pair", [True, False])
def test_mpd_matches_jax(mpd, waves, jax_outputs, pair):
    _, _, port = mpd
    y, y_hat = (t(w[:, None]) for w in waves)
    with torch.no_grad():
        ours = port(y, y_hat, pair=pair)
    for side_ours, side_jax in zip(ours, jax_outputs):
        assert len(side_ours) == len(side_jax) == 6
        for o, g in zip(side_ours, side_jax):
            if isinstance(o, list):  # one discriminator's feature maps
                assert len(o) == len(g)
                for fo, fg in zip(o, g):
                    np.testing.assert_allclose(_fmap_to_jax_layout(fo), fg,
                                               atol=1e-4, rtol=1e-3)
            else:
                np.testing.assert_allclose(o.numpy(), g, atol=1e-4, rtol=1e-3)


def test_fused_conv5_path_matches_default(mpd, waves):
    """fused_conv5=True (K5/K6's plain version on the CPU) gives the default
    discriminator's logits and parameter gradients."""
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    _, _, port = mpd
    fused = MultiPeriodDiscriminator(width=WIDTH, fused_conv5=True)
    fused.load_state_dict(port.state_dict(), strict=True)
    y, y_hat = (t(w[:, None]) for w in waves)
    grads = []
    for net in (port, fused):
        net.zero_grad()
        logits_r, logits_g, _, _ = net(y, y_hat, pair=True)
        loss = sum(((1 - r) ** 2).mean() + (g ** 2).mean() for r, g in zip(logits_r, logits_g))
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
        net.zero_grad()
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_losses_match_jax(mpd, waves, jax_outputs):
    from quickvc_tpu import losses as jl
    from quickvc_tpu_torch import losses

    _, _, port = mpd
    y, y_hat = (t(w[:, None]) for w in waves)
    with torch.no_grad():
        logits_r, logits_g, fmap_r, fmap_g = port(y, y_hat, pair=False)
    jr, jg, jfr, jfg = jax_outputs
    cases = [
        (losses.discriminator_loss(logits_r, logits_g), jl.discriminator_loss(jr, jg)),
        (losses.generator_loss(logits_g), jl.generator_loss(jg)),
        ((losses.feature_loss(fmap_r, fmap_g),), (jl.feature_loss(jfr, jfg),)),
    ]
    rng = np.random.default_rng(2)
    z_p, logs_q, m_p, logs_p = (rng.standard_normal((2, 16, 9)).astype(np.float32) * 0.5
                                for _ in range(4))
    cases.append(((losses.kl_loss(t(z_p), t(logs_q), t(m_p), t(logs_p)),),
                  (jl.kl_loss(*map(jnp.asarray, (z_p, logs_q, m_p, logs_p))),)))
    for ours, golden in cases:
        for o, g in zip(ours, golden):
            np.testing.assert_allclose(o.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


def test_reference_discriminator_checkpoint_loads_strictly(mpd, tmp_path):
    """A reference-layout D_*.pth written by the JAX package's exporter loads
    strictly and equals the port's own mapping of the same parameters."""
    from quickvc_tpu.utils.torch_export import export_discriminator, save_reference_checkpoint
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.utils.weights import load_discriminator

    _, params, port = mpd
    path = str(tmp_path / "D_0.pth")
    save_reference_checkpoint(path, export_discriminator(params), iteration=0,
                              learning_rate=2e-4)
    fresh = MultiPeriodDiscriminator(width=WIDTH)
    load_discriminator(path, fresh)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_training_forward_matches_jax(rng):
    """SynthesizerTrn.forward with the JAX rng's posterior noise and slice ids
    injected gives the JAX training forward's outputs and latents."""
    net, params, port = tiny_generator(seed=7)
    f = 21
    unit = rng.standard_normal((2, f, TINY_MODEL["unit_channels"])).astype(np.float32)
    spec = np.abs(rng.standard_normal((2, f, 33))).astype(np.float32)
    mel = rng.standard_normal((2, f, 80)).astype(np.float32)
    rngs = {"sample": jax.random.PRNGKey(3), "slice": jax.random.PRNGKey(4)}
    o, o_mb, ids, lat = jax.jit(lambda p, u, s, m: net.apply({"params": p}, u, s, m, rngs=rngs))(
        params, jnp.asarray(unit), jnp.asarray(spec), jnp.asarray(mel))
    z, _, _, _, m_q, logs_q = (np.asarray(a) for a in lat)
    eps_q = (z - m_q) / np.exp(logs_q)
    with torch.no_grad():
        ours = port(t(unit.transpose(0, 2, 1)), t(spec.transpose(0, 2, 1)),
                    t(mel.transpose(0, 2, 1)), eps_q=t(eps_q.transpose(0, 2, 1)),
                    ids_slice=torch.from_numpy(np.array(ids)))
    assert ours[0].shape == (2, 1, 8 * 320) and ours[1].shape == (2, 4, 8 * 320)
    np.testing.assert_allclose(ours[0][:, 0].numpy(), np.asarray(o)[..., 0], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(o_mb).transpose(0, 2, 1),
                               atol=1e-4, rtol=1e-3)
    for a, b in zip(ours[3], lat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 2, 1),
                                   atol=1e-4, rtol=1e-3)
