"""Shared set-up of the port's training-step tests: one tiny config, the same
seeded weights in the JAX train state and the port's, one JAX step with its
posterior noise and slice starts recovered, and the comparisons.

The JAX step derives its draws from ``jax.random.split(rng, 3)``
(``quickvc_tpu/train/step.py:175-176``); re-running the JAX generator
forward with the same rngs recovers ``eps = (z - m_q) / exp(logs_q)`` and
the slice starts, which the port's step takes as ``eps_q``/``ids_slice``.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_support import random_params

TINY = dict(
    train=dict(segment_size=2560, max_speclen=32, precision="f32", learning_rate=1e-4,
               disc_width=0.25, batch_size=2, loader_workers=2, log_interval=1),
    model=dict(inter_channels=16, hidden_channels=16, upsample_initial_channel=32,
               gin_channels=16, unit_channels=12, resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3, 5]], enc_wn_layers=2, flow_wn_layers=2,
               n_flows=2))
FRAMES = 16


MB = dict(ms_istft_vits=False, mb_istft_vits=True)   # the multiband decoder, sub-band loss on


def configs(model: dict | None = None, **train):
    """(JAX config, port config) of the tiny model updated by ``model``, same values."""
    from quickvc_tpu.config import config_from_dict as jax_config
    from quickvc_tpu_torch.config import config_from_dict

    d = {"train": dict(TINY["train"], **train), "model": dict(TINY["model"], **(model or {}))}
    return jax_config(d), config_from_dict(d)


def make_batch(rng: np.random.Generator, compact: bool, batch: int = 2) -> dict[str, np.ndarray]:
    unit = rng.standard_normal((batch, FRAMES, TINY["model"]["unit_channels"])).astype(np.float32)
    if compact:
        wave = rng.integers(-6000, 6000, (batch, FRAMES * 320 + 960)).astype(np.int16)
        return {"unit": unit, "wave_s16": wave,
                "n_take": np.array([FRAMES, FRAMES - 5][:batch], np.int32)}
    return {"unit": unit,
            "spec": (np.abs(rng.standard_normal((batch, FRAMES, 641))) * 0.3 + 0.01
                     ).astype(np.float32),
            "wave": np.clip(rng.standard_normal((batch, FRAMES * 320, 1)) * 0.2, -0.99, 0.99
                            ).astype(np.float32)}


def port_state(jcfg, cfg, g_params, d_params):
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)

    net_g = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
    net_g.load_state_dict(generator_state_dict_from_jax(g_params, cfg.model), strict=True)
    net_d = MultiPeriodDiscriminator(width=cfg.train.disc_width)
    net_d.load_state_dict(discriminator_state_dict_from_jax(d_params), strict=True)
    return create_train_state(cfg, torch.device("cpu"), net_g, net_d)


def jax_step(compact: bool, seed: int = 0, model: dict | None = None):
    """One JAX step (debug grads) on a seeded batch, the tiny model updated by
    ``model``; returns a dict with the configs, params before, batch, JAX
    metrics/state after and the draws."""
    from quickvc_tpu.dsp.mel import mel_filterbank
    from quickvc_tpu.dsp.stft import spec_to_mel, wave_to_spec_halo
    from quickvc_tpu.train import make_train_step
    from quickvc_tpu.train.state import TrainState, build_models, make_optimizer

    jcfg, cfg = configs(model)
    net_g, net_d = build_models(jcfg)
    key = jax.random.PRNGKey(0)
    f = FRAMES
    g_params = random_params(net_g, seed, {"params": key, "sample": key, "slice": key},
                             jnp.zeros((1, f, 12)), jnp.zeros((1, f, 641)), jnp.zeros((1, f, 80)))
    wave = jnp.zeros((1, jcfg.train.segment_size, 1))
    d_params = random_params(net_d, seed + 1, key, wave, wave, scale=0.2)
    opt = make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                       g_opt=opt.init(g_params), d_opt=opt.init(d_params))
    basis = jnp.asarray(mel_filterbank(16000, 1280, 80))
    batch = make_batch(np.random.default_rng(seed + 5), compact)
    rng = jax.random.PRNGKey(seed + 7)
    step = jax.jit(make_train_step(jcfg, net_g, net_d, basis, debug_grads=True))
    new_state, metrics = jax.device_get(step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                             rng))

    # the spectrogram the step saw, then the draws of its generator forward
    if compact:
        wf = jnp.asarray(batch["wave_s16"], jnp.float32) / 32768.0
        spec = wave_to_spec_halo(wf, 1280, 320, 1280)
        spec = spec * (jnp.arange(f)[None, :] < batch["n_take"][:, None])[..., None]
    else:
        spec = jnp.asarray(batch["spec"])
    rng_sample, rng_slice, _ = jax.random.split(rng, 3)
    fwd = jax.jit(lambda p, u, s: net_g.apply(
        {"params": p}, u, s, spec_to_mel(s, basis),
        rngs={"sample": rng_sample, "slice": rng_slice}))
    _, _, ids, (z, _, _, _, m_q, logs_q) = jax.device_get(
        fwd(g_params, jnp.asarray(batch["unit"]), spec))
    eps_q = (np.asarray(z) - m_q) / np.exp(logs_q)
    return dict(jcfg=jcfg, cfg=cfg, g_params=g_params, d_params=d_params, batch=batch,
                metrics=metrics, new_state=new_state, eps_q=eps_q.transpose(0, 2, 1),
                ids=np.array(ids))


def port_step(case):
    """The port's step on the same weights, batch and draws; returns
    (state before-copy of D params, state, metrics)."""
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    state = port_state(case["jcfg"], case["cfg"], case["g_params"], case["d_params"])
    d_before = {k: v.detach().clone() for k, v in state.net_d.named_parameters()}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case["batch"].items()}
    # torch's native CPU convolutions, not oneDNN's: oneDNN's float32 weight
    # gradient of the scale discriminator's first convolutions, after the
    # weight-norm projection, lands 1e-3 (one thread) to 3e-3 (four or more)
    # of the leaf's max away from JAX's; the native path agrees with JAX to
    # about 1e-5 at every thread count.
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = train_step(state, batch, mel_basis(case["cfg"], torch.device("cpu")),
                             eps_q=torch.from_numpy(case["eps_q"].copy()),
                             ids_slice=torch.from_numpy(case["ids"]), debug_grads=True)
    return d_before, state, metrics


def max_rel_err(ours: dict, golden: dict) -> tuple[float, str]:
    """max over tensors of max|a - b| / max(max|b|, 1e-6), and where."""
    worst, where = 0.0, ""
    for name, b in golden.items():
        a = ours[name].detach().numpy().astype(np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))
        if err > worst:
            worst, where = err, name
    return worst, where


def check_step_parity(case, ours) -> None:
    """Losses rtol 2e-4 / atol 1e-5; D and G grads max rel err 2e-3; the D
    update where the gradient is well determined (tests/test_grad_parity.py)."""
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)

    d_before, state, metrics = ours
    jm = case["metrics"]
    for key in ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl",
                "loss/g/subband", "loss/g/total", "grad_norm/d", "grad_norm/g"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    for key in ("loss/g", "loss/d/r", "loss/d/g", "img/mel_gen", "img/mel_org", "img/mel_all"):
        np.testing.assert_allclose(metrics[key].numpy(), np.asarray(jm[key]), rtol=2e-4,
                                   atol=1e-4, err_msg=key)
    assert float(metrics["guard/d_skipped"]) == float(jm["guard/d_skipped"]) == 0.0

    d_golden = discriminator_state_dict_from_jax(jm["debug/d_grads"])
    err, where = max_rel_err(metrics["debug/d_grads"], d_golden)
    assert err < 2e-3, f"D grads diverge: rel {err} at {where}"
    g_golden = generator_state_dict_from_jax(jm["debug/g_grads"], case["cfg"].model)
    g_golden.pop("dec.updown_filter", None)  # the multistream decoder's buffer, not a parameter
    err, where = max_rel_err(metrics["debug/g_grads"], g_golden)
    assert err < 2e-3, f"G grads diverge: rel {err} at {where}"

    # At step 1 AdamW moves each weight by about lr*(sign(g) + wd*w): compare
    # the applied updates where the gradient is well above its noise floor,
    # and bound the rest by the sign-flip envelope.
    lr = case["cfg"].train.learning_rate
    after_golden = discriminator_state_dict_from_jax(case["new_state"].d_params)
    after_ours = dict(state.net_d.named_parameters())
    for name, before in d_before.items():
        upd_o = after_ours[name].detach().numpy().astype(np.float64) - before.numpy()
        upd_g = after_golden[name].numpy().astype(np.float64) - before.numpy()
        diff = np.abs(upd_o - upd_g)
        g = np.abs(d_golden[name].numpy())
        mask = g >= 0.01 * g.max()
        assert diff[mask].max() < 1e-2 * lr, f"D update diverges at {name}"
        assert diff.max() < 2.1 * lr, f"D update beyond the sign-flip envelope at {name}"
