"""PyTorch port at bf16 (``train.precision: "bf16"``, ``realtime_bench
--precision bf16``) against the JAX package at bf16, at the tiny config of
``tests/torch_train_support.py`` with the same seeded weights.

- The wire: ``utils/bf16.py`` rounds float32 to the bits ``ml_dtypes`` gives
  (NaN and infinities included); the compact collate ships the JAX loader's
  bf16 units bit for bit; thread and process loaders give equal batches.
- One training step on a compact batch against the JAX bf16 step
  (``make_train_step(debug_grads=True)``), its posterior noise and slice
  starts recovered from the JAX generator forward. The JAX f32 step draws
  other noise (``jax.random.normal`` in float32 and in bf16 give other
  values), so the float32 yardstick is the port's float32 step on the same
  draws, which ``tests/test_torch_train_compact.py`` holds to the JAX f32
  step within 2e-4. To keep the file's cold JAX compile short, the
  discriminator is the scale one and the period-2 one (both packages take
  the periods as an argument), the update guard is off (its per-leaf
  selects double the compile; ``tests/test_torch_train_step.py`` holds the
  guard), and the JAX step compiles at XLA's optimisation level 0 (the
  numerics are the HLO's, which that level leaves as they are).
- The trainer CLI at ``precision: "bf16"``: two steps, one float32 eval, a
  checkpoint of float32 tensors, a resume.
- The live steps at bf16, unit and wave domain, against the JAX
  benchmark's ``synth_step`` / ``wave_step`` rebuilt here from
  ``scripts/realtime_bench.py:65-77`` (the script starts a benchmark when
  imported), the JAX f32 steps as the yardstick; the wave step also with a
  HuBERT that runs the ``pallas`` front and fused layers (K7 and K8 in
  their bf16 modes), the JAX one traced with ``jax.default_backend``
  reporting "tpu" and its Pallas kernels in interpret mode (off the TPU
  the JAX HuBERT takes its XLA paths, which round elsewhere).

Tolerances (PERF.md section 2), each relative to the bf16 error the
reference itself shows against float32:
losses ``|port - ref| <= max(2 |ref - f32|, 4e-3 |f32|)``; gradients, per
tensor, ``rel(port, ref) <= max(2 rel(ref, f32), 2e-2)``; waves
``max|port - ref| <= max(2 max|ref - f32|, 1e-2 peak)``; every parameter,
gradient and AdamW moment float32.

The gradients' ``rel`` is the L2 norm of the difference over the L2 norm of
the second tensor, not the max-norm: the port rounds each parameter
gradient to bf16 where it leaves the bf16 convolution (the dtype the policy
casts the weight to; cuDNN does the same on the card), while XLA on the CPU
keeps it in float32 (excess precision). Two bf16 computations with rounding
that independent differ by up to the sum of their errors, and a weight-norm
gain's gradient sums the rounded kernel gradient over the whole kernel, so
in the max-norm the port lands up to 2.24x the reference's own error
(``discriminators.0.convs.4.weight_g``) where its own bf16 error is larger
than JAX's; in the L2 norm every tensor is within 1.85x.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from test_torch_train_data import _both_configs, write_corpus
from torch_port_support import (TINY_MODEL, bf16_tensor, bf16_values, random_params,
                                tiny_generator, tiny_hubert)
from torch_train_support import FRAMES, configs, make_batch

from quickvc_tpu_torch.utils import bf16

HOP = 320
PERIODS = (2,)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LOSSES = ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl", "loss/g/total")
NO_GUARD = {"guard_nonfinite": False, "guard_loss_max": 0.0}


def compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's optimisation level 0."""
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)


def rel(a, b) -> float:
    """||a - b|| / ||b|| in the L2 norm."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_wire_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(20000) * 10.0 ** rng.uniform(-42, 38, 20000)
    bits = rng.integers(0, 2 ** 32, 50000, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 2 ** 16, 4000, dtype=np.uint32) << 16) | np.uint32(0x8000)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                        0xFFFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x80000000,
                        0x3F80FFFF, 0x3F818000], np.uint32)
    x = np.concatenate([normal.astype(np.float32), bits.view(np.float32),
                        ties.view(np.float32), special.view(np.float32)])
    with np.errstate(invalid="ignore", over="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = bf16.to_bits(x)
    assert got.dtype == np.uint16 and np.isnan(x).sum() > 100
    np.testing.assert_array_equal(got, want)
    finite = np.isfinite(x)
    # torch's own rounding agrees, and the tensor view shares the bits
    assert torch.equal(bf16_tensor(got)[finite].view(torch.int16),
                       torch.from_numpy(x[finite]).bfloat16().view(torch.int16))
    np.testing.assert_array_equal(bf16_values(got)[finite],
                                  want.view(ml_dtypes.bfloat16).astype(np.float32)[finite])


def test_compact_wire_ships_the_jax_loaders_bf16_units(tmp_path):
    """collate_batch against the JAX one (``ml_dtypes`` units), then thread
    against process loader workers, at ``precision: "bf16"``."""
    from quickvc_tpu.data.dataset import UnitAudioSpecDataset as JaxDataset
    from quickvc_tpu.data.dataset import collate_batch as jax_collate
    from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                                UnitAudioSpecDataset, collate_batch)

    listing = write_corpus(tmp_path, np.random.default_rng(3), [0.8, 0.9, 1.05, 0.75, 0.95])
    cfg, jcfg = _both_configs(listing, "compact")
    cfg.train.precision = jcfg.train.precision = "bf16"
    ds, jds = UnitAudioSpecDataset("train", cfg, with_spec=False), JaxDataset(
        "train", jcfg, with_spec=False)
    ours = collate_batch([ds[i] for i in range(3)], 40, cfg, np.random.default_rng(5))
    theirs = jax_collate([jds[i] for i in range(3)], 40, jcfg, np.random.default_rng(5))
    assert ours["unit"].dtype == np.uint16 and theirs["unit"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(ours["unit"], theirs["unit"].view(np.uint16))
    for k in ("wave_s16", "n_take"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    sampler = BucketSampler(ds.lengths, 2, BUCKET_BOUNDARIES)
    thread = DataLoader(ds, sampler, cfg, num_workers=1, seed=9)
    proc = DataLoader(ds, sampler, cfg, num_workers=1, seed=9, mode="process")
    try:
        want = list(thread)
        got = [{k: v.copy() for k, v in b.items()} for b in proc]
    finally:
        proc.close()
    assert len(got) == len(want) == len(sampler) > 1
    for a, b in zip(got, want):
        assert a["unit"].dtype == b["unit"].dtype == np.uint16
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def step_case():
    """The JAX bf16 step on a compact batch, and its draws."""
    from quickvc_tpu.dsp.mel import mel_filterbank
    from quickvc_tpu.dsp.stft import spec_to_mel, wave_to_spec_halo
    from quickvc_tpu.train import make_train_step
    from quickvc_tpu.train.state import TrainState, build_models, make_optimizer

    jcfg, _ = configs(precision="bf16", **NO_GUARD)
    net_g, net_d = build_models(jcfg)
    net_d = net_d.clone(periods=PERIODS)
    key, f = jax.random.PRNGKey(0), FRAMES
    g_params = random_params(net_g, 0, {"params": key, "sample": key, "slice": key},
                             jnp.zeros((1, f, 12)), jnp.zeros((1, f, 641)), jnp.zeros((1, f, 80)))
    wave = jnp.zeros((1, jcfg.train.segment_size, 1))
    d_params = random_params(net_d, 1, key, wave, wave, scale=0.2)
    opt = make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                       g_opt=opt.init(g_params), d_opt=opt.init(d_params))
    basis = jnp.asarray(mel_filterbank(16000, 1280, 80))
    batch = make_batch(np.random.default_rng(5), compact=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(7)
    step = make_train_step(jcfg, net_g, net_d, basis, debug_grads=True)
    _, metrics = jax.device_get(compiled(step, state, jbatch, rng)(state, jbatch, rng))

    wf = jnp.asarray(batch["wave_s16"], jnp.float32) / 32768.0
    spec = wave_to_spec_halo(wf, 1280, 320, 1280)
    spec = spec * (jnp.arange(f)[None, :] < batch["n_take"][:, None])[..., None]
    rng_sample, rng_slice, _ = jax.random.split(rng, 3)
    bf = jnp.bfloat16

    def fwd(p, u, s):
        return net_g.apply({"params": p}, u.astype(bf), s.astype(bf),
                           spec_to_mel(s, basis).astype(bf),
                           rngs={"sample": rng_sample, "slice": rng_slice})

    _, _, ids, (z, _, _, _, m_q, logs_q) = jax.device_get(
        compiled(fwd, g_params, jbatch["unit"], spec)(g_params, jbatch["unit"], spec))
    # The noise from the bf16 latents: (z - m_q) / exp(logs_q) taken in bf16
    # would lose bits, so it is taken in float32 from the float32-cast
    # latents and then rounded to bf16, the dtype the JAX draw had.
    z, m_q, logs_q = (np.asarray(x, np.float32) for x in (z, m_q, logs_q))
    eps = bf16_values(bf16.to_bits((z - m_q) / np.exp(logs_q)))
    return dict(g_params=g_params, d_params=d_params, batch=batch, metrics=metrics,
                eps=eps.transpose(0, 2, 1), ids=np.asarray(ids))


def _port_step(case, precision: str):
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)

    _, cfg = configs(precision=precision, **NO_GUARD)
    net_g = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
    net_g.load_state_dict(generator_state_dict_from_jax(case["g_params"], cfg.model), strict=True)
    net_d = MultiPeriodDiscriminator(PERIODS, width=cfg.train.disc_width)
    net_d.load_state_dict(discriminator_state_dict_from_jax(case["d_params"], PERIODS),
                          strict=True)
    state = create_train_state(cfg, torch.device("cpu"), net_g, net_d)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case["batch"].items()}
    if precision == "bf16":   # the units as the bf16 wire carries them
        batch["unit"] = bf16_tensor(bf16.to_bits(case["batch"]["unit"]))
    # torch's native CPU convolutions, as tests/torch_train_support.py:port_step
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = train_step(state, batch, mel_basis(cfg, torch.device("cpu")),
                             eps_q=torch.from_numpy(case["eps"].copy()),
                             ids_slice=torch.from_numpy(case["ids"].copy()), debug_grads=True)
    return state, metrics


def test_bf16_step_matches_jax(step_case):
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)

    state, ours = _port_step(step_case, "bf16")
    _, yard = _port_step(step_case, "f32")
    ref = step_case["metrics"]
    for key in LOSSES:
        o, r, y = float(ours[key]), float(ref[key]), float(yard[key])
        assert abs(o - r) <= max(2 * abs(r - y), 4e-3 * abs(y)), (key, o, r, y)
    assert "guard/d_skipped" not in ours and "guard/d_skipped" not in ref

    cfg_model = configs()[1].model
    golden = {"d": discriminator_state_dict_from_jax(ref["debug/d_grads"], PERIODS),
              "g": generator_state_dict_from_jax(ref["debug/g_grads"], cfg_model)}
    golden["g"].pop("dec.updown_filter")   # a buffer, not a parameter
    checked = 0
    for which, grads in golden.items():
        for name, r in grads.items():
            o = ours[f"debug/{which}_grads"][name]
            y = yard[f"debug/{which}_grads"][name]
            assert o.dtype == torch.float32, name
            err, bound = rel(o, r.numpy()), max(2 * rel(r.numpy(), y), 2e-2)
            assert err <= bound, (name, err, bound)
            checked += 1
    assert checked > 100

    for net, optim in ((state.net_g, state.optim_g), (state.net_d, state.optim_d)):
        assert all(p.dtype == torch.float32 for p in net.parameters())
        moments = [v for s in optim.state.values() for v in s.values()
                   if isinstance(v, torch.Tensor)]
        assert moments and all(v.dtype == torch.float32 for v in moments)
    assert all(v.dtype == torch.float32 for k, v in ours.items() if not k.startswith("debug/"))


def test_trainer_cli_bf16_trains_evaluates_and_resumes(tmp_path):
    from quickvc_tpu_torch.train import loop

    listing = write_corpus(tmp_path / "corpus", np.random.default_rng(4), [0.9, 0.95, 1.0, 0.85])
    _, cfg = configs(precision="bf16", transfer="compact", eval_interval=100, epochs=5)
    cfg.data.training_files = cfg.data.validation_files = listing
    hpfile = str(tmp_path / "tiny.json")
    cfg.save(hpfile)
    args = ["-c", hpfile, "-m", "run", "-mr", str(tmp_path / "logs"), "--device", "cpu"]
    out = loop.main(args + ["--max-steps", "2"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert all(np.isfinite(v) for step in out["losses"] for v in step.values())
    assert [e["step"] for e in out["evals"]] == [0]   # after update 1, in float32
    assert all(np.isfinite(v) for v in out["evals"][0].values())
    run_dir = tmp_path / "logs" / "run"
    for kind in "GD":
        ckpt = torch.load(run_dir / f"{kind}_2.pth", weights_only=True)
        assert all(v.dtype == torch.float32 for k, v in ckpt["model"].items())
        moments = [v for s in ckpt["optimizer"]["state"].values() for v in s.values()]
        assert moments and all(v.dtype == torch.float32 for v in moments)

    out = loop.main(args + ["--max-steps", "3"])
    assert out["steps"] == 3 and len(out["losses"]) == 1
    assert "Resumed from checkpoint at step 2" in (run_dir / "train.log").read_text()


@pytest.mark.parametrize("domain", ["units", "wave", "pallas_wave"])
def test_live_steps_match_jax_bench(domain, monkeypatch):
    """Two streams, a 32-frame window (left 16, chunk 8, right 8), noise 0;
    ``pallas_wave`` is the wave step with the `pallas` front and fused layers."""
    from jax.experimental.pallas import tpu as pltpu

    from quickvc_tpu.models.hubert import HubertSoft as JaxHubert
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
    from quickvc_tpu_torch.infer import RealtimeSession, RealtimeWaveSession

    left, chunk, right = 16, 8, 8
    window = left + chunk + right
    net, params, port = tiny_generator(seed=31)
    pallas = domain == "pallas_wave"
    jhub, h_params, hubert = tiny_hubert("pallas" if pallas else "faststats", seed=32,
                                         fused_layer=pallas)
    if pallas:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    rng = np.random.default_rng(33)
    g = rng.standard_normal((2, TINY_MODEL["gin_channels"])).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    if domain == "units":
        win = rng.standard_normal((2, window, TINY_MODEL["unit_channels"])).astype(np.float32)
    else:
        win = (0.1 * rng.standard_normal((2, window * HOP))).astype(np.float32)

    def jax_step(dtype):
        def synth_step(gp, units, gv):      # scripts/realtime_bench.py:65-70
            wave = net.apply({"params": gp}, units.astype(dtype), gv.astype(dtype), 0.0,
                             method=JaxSynth.infer)
            return jax.lax.dynamic_slice_in_dim(wave[..., 0], left * HOP, chunk * HOP, axis=1)

        def wave_step(hp, gp, wavein, gv):  # scripts/realtime_bench.py:72-75
            units = jhub.apply(hp, wavein.astype(dtype),
                               method=JaxHubert.units).astype(jnp.float32)
            return synth_step(gp, units, gv)

        fn, args = ((synth_step, (params, win, g)) if domain == "units"
                    else (wave_step, ({"params": h_params}, params, win, g)))
        with pltpu.force_tpu_interpret_mode() if pallas else contextlib.nullcontext():
            return np.asarray(compiled(fn, *args)(*args), np.float32)

    def port_step(dtype):
        kw = dict(chunk=chunk, left=left, right=right, device="cpu", dtype=dtype)
        session = (RealtimeSession(port, g, **kw) if domain == "units"
                   else RealtimeWaveSession(port, g, hubert, **kw))
        return session.step(torch.from_numpy(win)).numpy()

    ref, ref32 = jax_step(jnp.bfloat16), jax_step(jnp.float32)
    ours = port_step(torch.bfloat16)
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (2, chunk * HOP)
    err = np.abs(ours - ref).max()
    bound = max(2 * np.abs(ref - ref32).max(), 1e-2 * np.abs(ref32).max())
    assert err <= bound, f"max|port - jax| = {err:.3g}, {err / bound:.3f} of {bound:.3g}"
    # the float32 session is the JAX f32 step (tests/test_torch_realtime.py's 1e-4 x peak)
    assert np.abs(port_step(torch.float32) - ref32).max() <= 1e-4 * np.abs(ref32).max()
