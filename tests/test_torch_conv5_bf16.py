"""PyTorch port, the bf16 mode of K5/K6 (``ops.fused_disc_conv.conv5_lrelu``
on bf16 tensors) and the port of ``scripts/disc_pallas_ab.py``, held
against the JAX package on the CPU.

- ``conv5_lrelu`` at bf16, forward and its three gradients through the
  port's ``autograd.Function`` (plain forward and plain dW on the CPU),
  against ``jax.vjp`` of the JAX ``conv5_lrelu`` at bf16 with its Pallas
  kernels in interpret mode: every output bf16, as JAX's, within two bf16
  ulps of max|JAX| (each is a float32 sum rounded once; the sums' order
  differs).
- The port's ``DiscPVariant`` in its three modes against the JAX script's,
  imported from its path, weights carried by
  ``utils.weights.disc_variant_state_dict_from_jax``: one period (3, so the
  reflect pad runs) on a (2, 2048) bf16 wave, logits and parameter
  gradients of the script's loss, relative to JAX's own bf16 error against
  its float32 run on the same bf16-valued wave (PERF.md section 2): logits
  ``max|port - ref| <= max(2 max|ref - ref_f32|, 1e-2 peak)``; gradients, per
  tensor, ``rel(port, ref) <= max(2 rel(ref, ref_f32), 2e-2)`` in the L2
  norm, as ``tests/test_torch_bf16.py`` holds gradients against JAX (its
  note says why not the max-norm).
- ``MultiPeriodDiscriminator(fused_conv5=True)`` at width 0.25 on bf16 waves
  against the default bf16 MPD, relative to the default's bf16 error
  against its float32 run (the card's D-phase gate in ``chip_smoke.py``):
  loss ``|fused - ref| <= max(2 |ref - ref_f32|, 4e-3 |ref_f32|)``, each
  gradient ``maxrel(fused, ref) <= max(2 maxrel(ref, ref_f32), 2e-2)``;
  every parameter and gradient float32.
- The A/B script small on the CPU: one JSON line a timing.
"""

import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import random_params

from quickvc_tpu_torch.ops import fused_disc_conv as fdc

BF = torch.bfloat16


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def rel(a, b) -> float:
    """||a - b|| / ||b|| in the L2 norm."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def maxrel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-6))


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape", [(2, 21, 128, 128), (3, 9, 12, 20)])
def test_conv5_lrelu_bf16_matches_jax_vjp(shape):
    """(3, 9, 12 -> 20): channels that are not multiples of 8, which the JAX
    kernel takes whole (``_pick_tile``)."""
    from quickvc_tpu.ops.fused_disc_conv import conv5_lrelu as jax_conv5

    n, rows, c_in, c_out = shape
    rng = np.random.default_rng(c_in)
    x, k, b, dy = (jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16) for a in (
        0.5 * rng.standard_normal((n, rows, c_in)),
        rng.standard_normal((5, c_in, c_out)) / np.sqrt(5 * c_in),
        0.1 * rng.standard_normal(c_out), rng.standard_normal((n, rows, c_out))))
    with _interpret():
        y, vjp = jax.vjp(lambda x, k, b: jax_conv5(x, k, b, 0.1), x, k, b)
        golden = [y, *vjp(dy)]
    assert all(g.dtype == jnp.bfloat16 for g in golden)

    ins = [torch.from_numpy(_np(a)).to(BF).requires_grad_() for a in (x, k, b)]
    before = (fdc.BF16_STATS.launches, fdc.DW_BF16_STATS.launches)
    y_t = fdc.conv5_lrelu(*ins, 0.1)
    y_t.backward(torch.from_numpy(_np(dy)).to(BF))
    assert (fdc.BF16_STATS.launches, fdc.DW_BF16_STATS.launches) == before
    ours = [y_t.detach()] + [a.grad for a in ins]
    for name, o, g in zip(("y", "dx", "dw", "db"), ours, golden):
        assert o.dtype == BF and tuple(o.shape) == g.shape, name
        want = _np(g)
        peak = float(np.abs(want).max())
        assert float(np.abs(o.float().numpy() - want).max()) <= 2 * bf16_ulp(peak), name


def test_conv5_lrelu_bf16_masks_with_the_bf16_slope():
    """One tap of one channel, y < 0: every gradient is dym = bf16(dy *
    bf16(0.1)) exactly, as in JAX's VJP (0.0563964... at dy = 0.5625, where
    a float32 slope of 0.1 would give 0.0561523...)."""
    from quickvc_tpu.ops.fused_disc_conv import conv5_lrelu as jax_conv5

    x, k, b, dy = (np.full(shape, v, np.float32) for shape, v in (
        ((1, 1, 1), -1.0), ((5, 1, 1), 0.0), ((1,), 0.0), ((1, 1, 1), 0.5625)))
    k[2] = 1.0
    with _interpret():
        _, vjp = jax.vjp(lambda *a: jax_conv5(*a, 0.1),
                         *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, k, b)))
        golden = [_np(g) for g in vjp(jnp.asarray(dy).astype(jnp.bfloat16))]
    ins = [torch.from_numpy(a).to(BF).requires_grad_() for a in (x, k, b)]
    fdc.conv5_lrelu(*ins, 0.1).backward(torch.from_numpy(dy).to(BF))
    for ours, want in zip(ins, golden):
        np.testing.assert_array_equal(ours.grad.float().numpy(), want)
    assert float(ins[2].grad) == 0.056396484375


def _jax_script():
    """``scripts/disc_pallas_ab.py`` as a module (its ``main`` not run)."""
    if "jax_disc_pallas_ab" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "jax_disc_pallas_ab", "scripts/disc_pallas_ab.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod   # flax's dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules["jax_disc_pallas_ab"]


@pytest.mark.parametrize("mode", ["baseline", "outscale", "pallas_l5"])
def test_disc_variant_matches_the_jax_script(mode):
    from quickvc_tpu_torch.scripts.disc_pallas_ab import DiscPVariant
    from quickvc_tpu_torch.utils.weights import disc_variant_state_dict_from_jax

    script = _jax_script()
    period = 3
    wave = np.random.default_rng(5).standard_normal((2, 2048)).astype(np.float32) * 0.1
    x_bf = jnp.asarray(wave[..., None]).astype(jnp.bfloat16)
    net = script.DiscPVariant(period, mode)
    params = random_params(net, 7, jax.random.PRNGKey(0), x_bf)
    if mode == "pallas_l5":   # its weight-norm gain near 1, as random_params puts each "g"
        params["l5_g"] = params["l5_g"] + 1.0

    def jax_run(x):
        def loss(p):
            logit = net.apply({"params": p}, x)
            return jnp.mean((logit.astype(jnp.float32) - 1) ** 2), logit
        with _interpret():
            (_, logit), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return _np(logit), {k: v.numpy() for k, v in disc_variant_state_dict_from_jax(
            jax.tree_util.tree_map(_np, grads), mode).items()}

    (ref, ref_g), (ref32, ref32_g) = jax_run(x_bf), jax_run(x_bf.astype(jnp.float32))

    port = DiscPVariant(period, mode)
    port.load_state_dict(disc_variant_state_dict_from_jax(params, mode), strict=True)
    logit = port(torch.from_numpy(_np(x_bf)[:, None, :, 0]).to(BF))
    assert logit.dtype == BF
    grads = torch.autograd.grad(torch.mean((logit.float() - 1) ** 2), list(port.parameters()))
    ours = logit.detach().float().numpy()
    bound = max(2 * np.abs(ref - ref32).max(), 1e-2 * np.abs(ref32).max())
    assert ours.shape == ref.shape and np.abs(ours - ref).max() <= bound
    for (name, _), g in zip(port.named_parameters(), grads):
        assert g.dtype == torch.float32, name
        assert rel(g, ref_g[name]) <= max(2 * rel(ref_g[name], ref32_g[name]), 2e-2), name


def test_fused_mpd_at_bf16_matches_the_default():
    from quickvc_tpu_torch.losses import discriminator_loss
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.utils.weights import init_random_

    base = init_random_(MultiPeriodDiscriminator(width=0.25), 3)
    fused = MultiPeriodDiscriminator(width=0.25, fused_conv5=True)
    fused.load_state_dict(base.state_dict())
    rng = np.random.default_rng(9)
    y, y_hat = (torch.from_numpy(0.3 * rng.standard_normal((2, 1, 2560)).astype(np.float32))
                for _ in range(2))

    def d_phase(net, dtype):
        logits_r, logits_g, _, _ = net(y.to(dtype), y_hat.to(dtype), pair=True)
        loss = discriminator_loss([z.float() for z in logits_r], [z.float() for z in logits_g])[0]
        return loss, torch.autograd.grad(loss, list(net.parameters()))

    before = fdc.BF16_STATS.launches
    (loss_f, grads_f), (loss_b, grads_b), (loss_32, grads_32) = (
        d_phase(fused, BF), d_phase(base, BF), d_phase(base, torch.float32))
    assert fdc.BF16_STATS.launches == before   # the CPU runs the plain versions
    assert abs(float(loss_f - loss_b)) <= max(2 * abs(float(loss_b - loss_32)),
                                              4e-3 * abs(float(loss_32)))
    for (name, p), f, b, b32 in zip(fused.named_parameters(), grads_f, grads_b, grads_32):
        assert p.dtype == f.dtype == torch.float32, name
        assert maxrel(f, b) <= max(2 * maxrel(b, b32), 2e-2), name


def test_ab_script_runs_small_on_the_cpu(capsys):
    from quickvc_tpu_torch.scripts import disc_pallas_ab

    lines = disc_pallas_ab.main(["--device", "cpu", "--batch", "2", "--samples", "2048",
                                 "--iters", "1"])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines and len(lines) == 4 * 2 + 3 * 3
    assert [z["name"] for z in lines[:4]] == ["L5_p2_cudnn_fwd", "L5_p2_cudnn_grad",
                                              "L5_p2_fused_fwd", "L5_p2_fused_grad"]
    assert lines[-1]["name"] == "disc_p11_pallas_l5_grad"
    for z in lines:
        assert z["finite"] and z["ms"] > 0 and z["device"] == "cpu"
        assert z["launches"] == {"conv5_lrelu_bf16": 0, "conv5_lrelu_dw_bf16": 0}
