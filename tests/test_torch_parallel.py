"""PyTorch port, data-parallel training step (``quickvc_tpu_torch/parallel/``,
``train/step.py``) over two gloo ranks on the CPU, against the port's own
single-process step and against JAX's explicit-collective step.

- ``BucketSampler(num_replicas, rank)`` yields the JAX sampler's batches for
  every rank at 1, 2 and 4 ranks.
- Two ranks, each on its half of one 4-row batch with injected draws: the
  float32 data-parallel step against one process on the whole batch
  (losses rtol 2e-4, gradients max rel 2e-3); ZeRO-1 against replicated
  (parameters and moments bit-equal: AdamW's update is elementwise, and the
  flat shard and the per-tensor update round alike); each rank holding half
  the moment bytes; the ranks ending bit-equal.
- ``split_prior`` with the bf16 gradient reduce against
  ``quickvc_tpu.parallel.make_sharded_train_step(reduce_dtype=bf16,
  per_shard_rng=False)`` on a 2-device CPU mesh (one JAX step compile),
  fed the same weights, batch and per-shard draws.
- ``split_prior`` in one process equals the unsplit step on the same draws.
- The multiband model's sub-band loss at two ranks: at a float32 reduce its
  spectral convergence is one ratio over both ranks' rows, so
  ``loss/g/subband`` and the gradients equal one process on the global
  batch (and the old rank-local mean misses it by far more than the
  tolerance); at a bf16 reduce it stays each rank's ratio, averaged.
- Tensor parallelism (``parallel/tp.py``): each parameter of G and D split on
  the torch dim that JAX's ``_kernel_spec`` splits, carried through
  ``utils/weights.py``, at model 2 and 4; at ``configs/quickvc_tp.json`` the
  bytes a device equal JAX's count (no allocation: the meta device and
  ``eval_shape``); one float32 step on a 2 x 2 and a 1 x 2 (data, model)
  mesh of gloo ranks against one process on the global batch, model ranks
  bit-equal; ``infer`` sharded against whole; the refusals.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dist_support import start
from torch_train_support import FRAMES, MB, TINY, configs, max_rel_err

import torch_port_support  # noqa: F401  (caps torch's threads)

ROWS = 4   # the global batch: two rows a rank
TP_MESHES = [(2, 2), (1, 2)]   # (data, model)
LOSSES = ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl",
          "loss/g/subband", "loss/g/total")


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_sampler_matches_jax_for_every_rank(replicas):
    from quickvc_tpu.data.dataset import BucketSampler as JaxSampler
    from quickvc_tpu_torch.data.dataset import BUCKET_BOUNDARIES, BucketSampler

    lengths = np.random.default_rng(3).integers(20, 700, 97).tolist()
    for rank in range(replicas):
        ours = BucketSampler(lengths, 3, BUCKET_BOUNDARIES, num_replicas=replicas, rank=rank)
        ref = JaxSampler(lengths, 3, BUCKET_BOUNDARIES, num_replicas=replicas, rank=rank)
        assert ours.num_samples_per_bucket == ref.num_samples_per_bucket
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = [(k, [int(i) for i in ids]) for k, ids in ours]
            assert got == [(k, [int(i) for i in ids]) for k, ids in ref]
            assert len(got) == len(ours) == len(ref)


def _batch(rng: np.random.Generator) -> dict[str, np.ndarray]:
    unit = rng.standard_normal((ROWS, FRAMES, TINY["model"]["unit_channels"]))
    return {"unit": unit.astype(np.float32),
            "wave_s16": rng.integers(-6000, 6000, (ROWS, FRAMES * 320 + 960)).astype(np.int16),
            "n_take": np.array([FRAMES, FRAMES - 5, FRAMES - 2, FRAMES], np.int32)}


def _mb_batch() -> dict[str, np.ndarray]:
    """The case's batch for the multiband model: no masked tail (over digital
    silence the sub-band loss is +inf, as in JAX, which compares nothing),
    and the second rank's waves 8x quieter, so that its rows' spectral
    convergence differs from the first rank's as utterances do."""
    batch = _batch(np.random.default_rng(5))
    wave = batch["wave_s16"].copy()
    wave[ROWS // 2 :] //= 8
    return {"n_take": np.full(ROWS, FRAMES, np.int32), "wave_s16": wave}


VARIANTS = {"f32": {}, "zero": {"zero_opt_state": True},
            "split_bf16": {"split_prior": True, "grad_reduce_dtype": "bf16"},
            "mb_f32": {"model": MB, "batch": _mb_batch()},
            "mb_bf16_reduce": {"model": MB, "grad_reduce_dtype": "bf16", "batch": _mb_batch()},
            "bf16_step": {"precision": "bf16"}}


def _jax_case():
    """The case of JAX's shard_map step (split_prior, bf16 reduce, the same
    key on both shards): weights, batch and each shard's draws recovered;
    the JAX parameters; the step's inputs for :func:`_jax_sharded_step`."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quickvc_tpu.dsp.mel import mel_filterbank
    from quickvc_tpu.dsp.stft import spec_to_mel, wave_to_spec_halo
    from quickvc_tpu.train.state import TrainState, build_models, make_optimizer
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)
    from torch_port_support import random_params

    jcfg, cfg = configs(**VARIANTS["split_bf16"])
    net_g, net_d = build_models(jcfg)
    key = jax.random.PRNGKey(0)
    g_params = random_params(net_g, 0, {"params": key, "sample": key, "slice": key},
                             jnp.zeros((1, FRAMES, 12)), jnp.zeros((1, FRAMES, 641)),
                             jnp.zeros((1, FRAMES, 80)))
    wave = jnp.zeros((1, jcfg.train.segment_size, 1))
    d_params = random_params(net_d, 1, key, wave, wave, scale=0.2)
    opt = make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                       g_opt=opt.init(g_params), d_opt=opt.init(d_params))
    basis = jnp.asarray(mel_filterbank(16000, 1280, 80))
    batch = _batch(np.random.default_rng(5))
    rng = jax.random.PRNGKey(7)

    # each shard's draws: its forward_posterior with the step's sample/slice keys
    wf = jnp.asarray(batch["wave_s16"], jnp.float32) / 32768.0
    spec = wave_to_spec_halo(wf, 1280, 320, 1280)
    spec = spec * (jnp.arange(FRAMES)[None, :] < batch["n_take"][:, None])[..., None]
    rng_sample, rng_slice, _ = jax.random.split(rng, 3)
    fwd = jax.jit(lambda p, s: net_g.apply(
        {"params": p}, s, spec_to_mel(s, basis), rngs={"sample": rng_sample, "slice": rng_slice},
        method="forward_posterior"))
    eps, ids = [], []
    for rows in (slice(0, 2), slice(2, 4)):
        _, _, i, (z, _, m_q, logs_q) = jax.device_get(fwd(g_params, spec[rows]))
        eps.append(((np.asarray(z) - m_q) / np.exp(logs_q)).transpose(0, 2, 1))
        ids.append(np.asarray(i))
    case = {"config": {"train": dict(TINY["train"]), "model": dict(TINY["model"])},
            "g": generator_state_dict_from_jax(g_params, cfg.model),
            "d": discriminator_state_dict_from_jax(d_params),
            "batch": batch, "eps_q": np.concatenate(eps).astype(np.float32),
            "ids": np.concatenate(ids)}
    return case, (g_params, d_params), (jcfg, net_g, net_d, basis, state, batch, rng)


def _jax_sharded_step(jcfg, net_g, net_d, basis, state, batch, rng):
    """JAX's shard_map step on the case, on a 2-device mesh: (metrics, state after)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quickvc_tpu.parallel import data_parallel_mesh, make_sharded_train_step

    mesh = data_parallel_mesh(2)
    step = make_sharded_train_step(jcfg, net_g, net_d, basis, mesh, reduce_dtype=jnp.bfloat16,
                                   per_shard_rng=False, debug_grads=True)
    new_state, metrics = jax.device_get(step(
        jax.device_put(state, NamedSharding(mesh, P())),
        jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       NamedSharding(mesh, P("data"))), rng))
    return metrics, new_state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference, the two ranks' steps of every variant, and one
    process's float32 step on the whole batch. The case is written first;
    then the data-parallel ranks and every tensor-parallel mesh's ranks
    (``tp_runs``) start together, each group in a directory of its own, and
    run while the JAX step compiles."""
    from torch_dist_support import _case_state

    from quickvc_tpu_torch.train.step import mel_basis, train_step

    tmp = tmp_path_factory.mktemp("dp")
    case, jax_params, jax_inputs = _jax_case()
    torch.save(case, tmp / "case.pt")
    groups = {"dp": start("step_job", 2, tmp, VARIANTS, timeout=600)}
    for data, model in TP_MESHES:
        sub = tmp / f"tp_{data}x{model}"
        sub.mkdir()
        shutil.copy(tmp / "case.pt", sub / "case.pt")
        groups[data, model] = start("tp_job", data * model, sub, data, model, timeout=600)
    try:
        jax_metrics, jax_state = _jax_sharded_step(*jax_inputs)
        ranks = groups["dp"].join()
    except BaseException:
        for g in groups.values():
            g.kill()
        raise

    def one_process(rows=slice(None), batch=None, **train):
        state = _case_state(case, **train)
        batch = {k: torch.from_numpy(v[rows].copy()) for k, v in (case["batch"] | (batch or {})
                                                                   ).items()}
        with torch.backends.mkldnn.flags(enabled=False):
            m = train_step(state, batch, mel_basis(state.cfg, torch.device("cpu")),
                           eps_q=torch.from_numpy(case["eps_q"][rows].copy()),
                           ids_slice=torch.from_numpy(case["ids"][rows].copy()), debug_grads=True)
        return state, m

    yield {"case": case, "jax_metrics": jax_metrics, "jax_state": jax_state, "ranks": ranks,
           "one_process": one_process, "tmp": tmp, "jax_params": jax_params,
           "tp_groups": {mesh: groups[mesh] for mesh in TP_MESHES}}
    for g in groups.values():   # a run that never reached tp_runs
        g.kill()


def _assert_matches_one_process(ours: dict, single: dict,
                                grads=("debug/d_grads", "debug/g_grads")) -> None:
    """Losses rtol 2e-4, gradients max rel 2e-3 (the data-parallel test's gates)."""
    for key in LOSSES + ("grad_norm/d", "grad_norm/g"):
        np.testing.assert_allclose(float(ours[key]), float(single[key]), rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    for kind in grads:
        assert all(torch.isfinite(v).all() for v in single[kind].values()), kind
        err, where = max_rel_err(ours[kind], {k: v.numpy() for k, v in single[kind].items()})
        assert err < 2e-3, f"{kind}: rel {err} at {where}"


def test_dp_step_matches_one_process_on_the_global_batch(runs):
    _, single = runs["one_process"]()
    ours = runs["ranks"][0]["f32"]["metrics"]
    _assert_matches_one_process(ours, single)
    for key in ("loss/g", "loss/d/r", "loss/d/g"):
        np.testing.assert_allclose(ours[key].numpy(), single[key].numpy(), rtol=2e-4,
                                   atol=1e-4, err_msg=key)


def _equal_states(a: dict, b: dict) -> list[str]:
    """Names of the parameter or moment tensors that differ in any bit."""
    bad = [f"{n}.{k}" for n in ("g", "d") for k in a[n] if not torch.equal(a[n][k], b[n][k])]
    for n in ("opt_g", "opt_d"):
        sa, sb = a[n]["state"], b[n]["state"]
        assert sa.keys() == sb.keys(), n
        bad += [f"{n}.{i}.{k}" for i in sa for k in sa[i] if not torch.equal(sa[i][k], sb[i][k])]
    return bad


def test_zero1_matches_replicated_dp_bit_for_bit(runs):
    for rank in runs["ranks"]:
        zero, rep = rank["zero"], rank["f32"]
        assert not _equal_states(zero, rep), _equal_states(zero, rep)[:5]
        for key in LOSSES:
            assert float(zero["metrics"][key]) == float(rep["metrics"][key]), key
        for key in ("grad_norm/d", "grad_norm/g"):   # per-shard partial sums: other order
            np.testing.assert_allclose(float(zero["metrics"][key]), float(rep["metrics"][key]),
                                       rtol=1e-5, err_msg=key)


def test_zero1_rank_holds_half_the_moments(runs):
    replicated = runs["ranks"][0]["f32"]["moment_bytes"]
    n_params = len(runs["case"]["g"]) + len(runs["case"]["d"])
    assert replicated > 0 and n_params > 10
    for rank in runs["ranks"]:
        # two moments of two networks, each padded by less than one element
        assert abs(rank["zero"]["moment_bytes"] - replicated / 2) <= 2 * 2 * 4, (
            rank["zero"]["moment_bytes"], replicated)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ranks_end_bit_equal(runs, variant):
    r0, r1 = (r[variant] for r in runs["ranks"])
    assert not _equal_states(r0, r1), _equal_states(r0, r1)[:5]
    for key, v in r0["metrics"].items():
        if not key.startswith("debug/"):
            assert torch.equal(v, r1["metrics"][key]), key


def _d_grad_sensitivity(case: dict, rel: float = 1e-6
                        ) -> tuple[dict[str, float], dict[str, torch.Tensor]]:
    """Per D parameter, the largest relative change of the port's D-phase
    gradient (each shard's rows, the case's draws) when the generated wave
    it takes is multiplied by 1 + rel * N(0, 1), over two draws. At random
    weights a leaky ReLU whose input sits within float32 noise of its kink
    changes slope under such a change: the JAX and port waves differ by
    about that much (float32 summation order), so their D gradients may too,
    and no gate tighter than this measures the port. Also returns the first
    shard's own D gradient, unreduced: the control that gate must refuse."""
    from torch_dist_support import _case_state

    from quickvc_tpu_torch.dsp.stft import spec_to_mel
    from quickvc_tpu_torch.losses import discriminator_loss
    from quickvc_tpu_torch.ops.slicing import slice_segments
    from quickvc_tpu_torch.train.step import decode_batch, mel_basis

    state = _case_state(case)
    names, params = zip(*state.net_d.named_parameters())
    gen = torch.Generator().manual_seed(0)
    out, local = dict.fromkeys(names, 0.0), {}
    for rows in (slice(0, 2), slice(2, 4)):
        batch = {k: torch.from_numpy(v[rows].copy()) for k, v in case["batch"].items()}
        unit, spec, wave = decode_batch(batch, state.cfg)
        mel = spec_to_mel(spec, mel_basis(state.cfg, torch.device("cpu")))
        with torch.backends.mkldnn.flags(enabled=False):
            y_hat, _, ids, _ = state.net_g.forward_posterior(
                spec.transpose(1, 2), mel.transpose(1, 2), eps_q=torch.from_numpy(
                    case["eps_q"][rows].copy()), ids_slice=torch.from_numpy(case["ids"][rows]))
            y_seg = slice_segments(wave[:, None], ids * 320, state.cfg.train.segment_size)

            def grads(y):
                logits_r, logits_g, _, _ = state.net_d(y_seg, y.detach(), pair=True)
                return torch.autograd.grad(discriminator_loss(logits_r, logits_g)[0], params)

            base = grads(y_hat)
            local = local or dict(zip(names, base))
            for _ in range(2):
                moved = grads(y_hat * (1 + rel * torch.randn(y_hat.shape, generator=gen)))
                for n, a, b in zip(names, moved, base):
                    out[n] = max(out[n], float((a - b).abs().max() / b.abs().max().clamp_min(1e-12)))
    return out, local


def test_split_prior_bf16_reduce_matches_jax_shard_map(runs):
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)

    jm, cfg = runs["jax_metrics"], configs()[1]
    ours = runs["ranks"][0]["split_bf16"]
    m = ours["metrics"]
    for key in LOSSES + ("grad_norm/d", "grad_norm/g"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    for key in ("loss/g", "loss/d/r", "loss/d/g", "img/mel_gen", "img/mel_org", "img/mel_all"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=2e-4, atol=1e-4,
                                   err_msg=key)
    goldens = {"debug/d_grads": discriminator_state_dict_from_jax(jm["debug/d_grads"]),
               "debug/g_grads": generator_state_dict_from_jax(jm["debug/g_grads"], cfg.model)}
    goldens["debug/g_grads"].pop("dec.updown_filter", None)
    sensitivity, local = _d_grad_sensitivity(runs["case"])
    gates = {}
    for kind, golden in goldens.items():
        # Both sides round their own float32 mean to bf16: an element whose
        # float32 values straddle a rounding boundary lands one bf16 ulp apart
        # (2^-8 of it). Beyond that one ulp the float32 gate applies, widened
        # for a D gradient by what a float32-sized change of D's input moves
        # it (see _d_grad_sensitivity).
        straddles, total = 0, 0
        for name, b in golden.items():
            a = m[kind][name].double().numpy()
            b = b.double().numpy()
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
            diff = np.abs(a - b)
            straddles += int((diff > 0).sum() - (diff > ulp * 1.0001).sum())
            total += b.size
            err = float(np.maximum(diff - ulp, 0.0).max() / max(np.abs(b).max(), 1e-6))
            gate = 2e-3 + 2 * sensitivity.get(name, 0.0) * (kind == "debug/d_grads")
            gates[kind, name] = gate
            assert err < gate, f"{kind}: rel {err} beyond one bf16 ulp at {name} (gate {gate})"
        # a rounding that differs in kind (truncation, a second rounding) would
        # put about half of the elements one ulp apart, float32 noise ~1 %
        assert straddles <= 0.05 * total, f"{kind}: {straddles} of {total} elements one ulp apart"
    # the control: the widened D gate still refuses one shard's own gradient
    # (a rank dropped from the mean)
    golden = goldens["debug/d_grads"]
    refused = [name for name, g in local.items()
               if float((g.double() - golden[name].double()).abs().max()
                        / golden[name].double().abs().max().clamp_min(1e-6))
               >= gates["debug/d_grads", name]]
    assert refused, "the D gate passes a shard's unreduced gradient"

    # the D update where the gradient is well determined (check_step_parity's rule)
    lr = cfg.train.learning_rate
    before = runs["case"]["d"]
    after_golden = discriminator_state_dict_from_jax(runs["jax_state"].d_params)
    for name, b in before.items():
        upd_o = ours["d"][name].double() - b.double()
        upd_g = after_golden[name].double() - b.double()
        g = goldens["debug/d_grads"][name].abs()
        mask = g >= 0.01 * g.max()
        diff = (upd_o - upd_g).abs()
        assert float(diff[mask].max()) < 1e-2 * lr, name
        assert float(diff.max()) < 2.1 * lr, name


def test_split_prior_equals_unsplit_step(runs):
    """One process: the split step's losses, gradients and updates are the
    unsplit step's on the same draws."""
    split_state, split = runs["one_process"](split_prior=True)
    plain_state, plain = runs["one_process"]()
    for key in LOSSES + ("grad_norm/d", "grad_norm/g"):
        assert float(split[key]) == float(plain[key]), key
    for kind in ("debug/d_grads", "debug/g_grads"):
        for name, v in plain[kind].items():
            assert torch.equal(split[kind][name], v), (kind, name)
    for a, b in ((split_state.net_g, plain_state.net_g), (split_state.net_d, plain_state.net_d)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name


def test_mb_subband_loss_at_a_float32_reduce_is_global(runs):
    """Two ranks, the multiband model, float32 reduce: every loss (the
    sub-band loss among them) and G's reduced gradients equal one process on
    the 4 rows. The control: the mean of the two ranks' own ratios (what the
    reduce took before) misses the global ``loss/g/subband`` by more than
    10x the loss tolerance. (D's gradients are the data-parallel test's
    concern: at a leaky ReLU's kink the first period conv's moves by 2.3e-3
    of its max here, as ``_d_grad_sensitivity`` says.)"""
    _, single = runs["one_process"](**VARIANTS["mb_f32"])
    ours = runs["ranks"][0]["mb_f32"]["metrics"]
    assert 0 < float(single["loss/g/subband"]) < np.inf
    _assert_matches_one_process(ours, single, grads=("debug/g_grads",))
    local = np.mean([float(runs["one_process"](rows, **VARIANTS["mb_f32"])[1]["loss/g/subband"])
                     for rows in (slice(0, 2), slice(2, 4))])
    glob = float(single["loss/g/subband"])
    assert abs(local - glob) > 10 * (1e-5 + 2e-4 * abs(glob)), (local, glob)


def test_bf16_step_feature_loss_at_a_float32_reduce_is_global(runs):
    """A bf16 step on two ranks, float32 reduce: each feature-matching mean
    is the 4 rows' float32 mean rounded to bf16 once, so ``loss/g/fm`` is
    one process's bf16 value to the bit (the ranks' rounded means averaged
    would stand a bf16 rounding off)."""
    _, single = runs["one_process"](precision="bf16")
    ours = runs["ranks"][0]["bf16_step"]["metrics"]
    assert np.isfinite(float(single["loss/g/fm"]))
    assert float(ours["loss/g/fm"]) == float(single["loss/g/fm"])


def test_mb_subband_loss_at_a_bf16_reduce_stays_rank_local(runs):
    """At a bf16 reduce the two ranks average their own ratios, as JAX's
    shard_map step does: ``loss/g/subband`` is the mean of one process's
    value on each rank's rows."""
    ours = float(runs["ranks"][0]["mb_bf16_reduce"]["metrics"]["loss/g/subband"])
    local = np.mean([float(runs["one_process"](rows, **VARIANTS["mb_f32"])[1]["loss/g/subband"])
                     for rows in (slice(0, 2), slice(2, 4))])
    assert np.isfinite(local)
    np.testing.assert_allclose(ours, local, rtol=2e-4, atol=1e-5)


# --------------------------------------------------------------------------
# tensor parallelism


@pytest.fixture(scope="module")
def tp_runs(runs):
    """Each (data, model) mesh of TP_MESHES, its ranks on the case
    (``torch_dist_support.tp_job``), and one process's float32 step on the
    whole batch."""
    state, single = runs["one_process"]()
    return {"ranks": {mesh: runs["tp_groups"][mesh].join() for mesh in TP_MESHES},
            "state": state, "single": single}


def _tagged(tree):
    """Each leaf of a JAX parameter tree replaced by its index * 4096 plus
    1 + the position along its last axis (exact in float32): a mapped
    tensor tells which leaf it came from and along which dims that leaf's
    last axis runs."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tagged = [np.broadcast_to(i * 4096 + 1 + np.arange(x.shape[-1], dtype=np.float32),
                              x.shape).copy() for i, x in enumerate(leaves)]
    return leaves, jax.tree_util.tree_unflatten(treedef, tagged)


@pytest.mark.parametrize("model", [2, 4])
def test_tp_layout_is_jax_kernel_spec_per_leaf(runs, model):
    """Every parameter of G and D at the tiny config (min_channels 16): the
    port splits the torch dim along which JAX's last axis runs after
    ``utils/weights.py``'s mapping exactly when ``_kernel_spec`` splits that
    leaf, and nothing else. Among them: ``ConvTranspose1d`` on its input
    channels, the LSTM weights on dim 1, the last res/skip layer of each
    WaveNet by JAX's 2h."""
    from quickvc_tpu.parallel.tp import _kernel_spec
    from quickvc_tpu_torch.parallel.tp import param_layout
    from quickvc_tpu_torch.train.state import build_models
    from quickvc_tpu_torch.utils.weights import (discriminator_state_dict_from_jax,
                                                 generator_state_dict_from_jax)

    cfg = configs()[1]
    net_g, net_d = build_models(cfg)
    g_params, d_params = runs["jax_params"]
    kinds = set()
    for net, tree, mapping in (
            (net_g, g_params, lambda t: generator_state_dict_from_jax(t, cfg.model)),
            (net_d, d_params, discriminator_state_dict_from_jax)):
        layout = param_layout(net, model, 16)
        leaves, tagged = _tagged(tree)
        mapped = mapping(tagged)
        assert set(layout) <= set(mapped)
        for name, dim in layout.items():
            t = mapped[name].numpy()
            leaf = leaves[int(t.flat[0] // 4096)]
            assert np.all(t // 4096 == t.flat[0] // 4096), name
            runs_along = [d for d in range(t.ndim) if (np.diff(t, axis=d) != 0).any()]
            jax_split = "model" in str(_kernel_spec((), leaf, model, 16))
            if jax_split:
                assert runs_along == [dim], (name, dim, runs_along, leaf.shape)
                kinds.add((name.rsplit(".", 1)[-1], dim))
            else:
                assert dim is None, (name, dim, leaf.shape)
    assert {("weight_v", 0), ("weight_ih_l1", 1), ("weight_hh_l0", 1), ("bias_ih_l0", 0)} <= kinds
    ups = [n for n, d in param_layout(net_g, model, 16).items() if n.startswith("dec.ups.")]
    assert "dec.ups.0.weight_v" in ups   # (in, out, k): split on its 32 input channels


def test_tp_layout_at_the_scaled_config_matches_jax_bytes():
    """``configs/quickvc_tp.json`` (upsample_initial_channel 4096), model 8,
    min_channels 256: the port's G (on the meta device) holds JAX's bytes in
    all and a device, once the unused res half of each WaveNet's last
    res/skip layer (JAX's alone) is taken out; over 2.5e9 bytes, at least 5x
    fewer a device, over 20 split tensors (``test_scaled_tp_config_layout``'s
    bounds)."""
    import os

    from quickvc_tpu.config import load_config as jax_load_config
    from quickvc_tpu.parallel.tp import _kernel_spec
    from quickvc_tpu.train.state import build_models as jax_build_models
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.parallel.tp import param_layout

    path = os.path.join(os.path.dirname(__file__), "..", "configs", "quickvc_tp.json")
    jcfg = jax_load_config(path)
    jnet_g, _ = jax_build_models(jcfg)
    k, f = jax.random.PRNGKey(0), 32
    abstract = jax.eval_shape(lambda: jnet_g.init(
        {"params": k, "sample": k, "slice": k}, jnp.zeros((1, f, jcfg.model.unit_channels)),
        jnp.zeros((1, f, jcfg.spec_channels)), jnp.zeros((1, f, jcfg.data.n_mel_channels))))
    jax_total = jax_device = unused_total = unused_device = 0
    for path_, leaf in jax.tree_util.tree_flatten_with_path(abstract["params"])[0]:
        b = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        split = "model" in str(_kernel_spec(path_, leaf, 8, 256))
        jax_total += b
        jax_device += b // 8 if split else b
        keys = [getattr(p, "key", "") for p in path_]
        if keys[-2:-1] == ["res_skip"]:   # (L, ..., 2h): the last layer's first h of 2h
            n = int(np.prod(leaf.shape[1:-1])) * leaf.shape[-1] // 2 * leaf.dtype.itemsize
            unused_total += n
            unused_device += n // 8 if split else n

    cfg = load_config(path)
    with torch.device("meta"):
        net_g = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
    layout = param_layout(net_g, 8, 256)
    total = device = split_tensors = 0
    for name, p in net_g.named_parameters():
        b = p.numel() * p.element_size()
        total += b
        device += b // 8 if layout[name] is not None else b
        split_tensors += layout[name] is not None
    assert (total + unused_total, device + unused_device) == (jax_total, jax_device)
    assert total > 2_500_000_000 and device * 5 < total and split_tensors > 20, (
        total, device, split_tensors)


def test_tp_batch_splits_over_data_only():
    """The model ranks of one data index take the same rows, sampler batches
    and step seed; the data indices split them."""
    from quickvc_tpu_torch.data.dataset import BUCKET_BOUNDARIES, BucketSampler
    from quickvc_tpu_torch.parallel.tp import Mesh2D, batch_rows, bucket_sampler, step_seed

    lengths = np.random.default_rng(3).integers(20, 700, 97).tolist()
    for d in range(2):
        ref = BucketSampler(lengths, 3, BUCKET_BOUNDARIES, num_replicas=2, rank=d)
        meshes = [Mesh2D(2, 2, d, m, None, None) for m in range(2)]
        assert {batch_rows(x, 8) for x in meshes} == {slice(4 * d, 4 * d + 4)}
        assert len({step_seed(5, x) for x in meshes}) == 1
        for x in meshes:
            assert list(bucket_sampler(lengths, 3, x)) == list(ref)
    assert step_seed(5, Mesh2D(2, 2, 0, 0, None, None)) != step_seed(5, Mesh2D(2, 2, 1, 0, None,
                                                                                  None))


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_step_matches_one_process_on_the_global_batch(tp_runs, mesh):
    """One float32 step on the mesh: losses, grad_norm/*, the gathered
    gradients, and the parameters and AdamW moments after it against one
    process on the 4 rows (losses rtol 2e-4, the rest max rel 2e-3), on
    every rank; each rank holds fewer parameter and moment bytes."""
    state, single = tp_runs["state"], tp_runs["single"]
    whole = {"g": state.net_g.state_dict(), "d": state.net_d.state_dict()}
    moments = {"g": state.optim_g.state_dict()["state"], "d": state.optim_d.state_dict()["state"]}
    worst = dict.fromkeys(("grads", "params", "moments"), 0.0)
    for rank in tp_runs["ranks"][mesh]:
        _assert_matches_one_process(rank["metrics"], single)
        for kind in "gd":
            err, _ = max_rel_err(rank["metrics"][f"debug/{kind}_grads"],
                                 {k: v.numpy() for k, v in single[f"debug/{kind}_grads"].items()})
            worst["grads"] = max(worst["grads"], err)
            err, where = max_rel_err(rank[kind], {k: v.numpy() for k, v in whole[kind].items()})
            assert err < 2e-3, f"{kind} after the step: rel {err} at {where}"
            worst["params"] = max(worst["params"], err)
            ours = rank[f"opt_{kind}"]["state"]
            assert ours.keys() == moments[kind].keys()
            for i, st in moments[kind].items():
                for name in ("exp_avg", "exp_avg_sq"):
                    e, _ = max_rel_err({0: ours[i][name]}, {0: st[name].numpy()})
                    assert e < 2e-3, (kind, i, name, e)
                    worst["moments"] = max(worst["moments"], e)
            held = rank["bytes"][kind]
            full = sum(v.numel() * v.element_size() for v in whole[kind].values()
                       if v.dtype.is_floating_point)
            assert held["params"] < full and held["moments"] == 2 * held["params"]
    print(f"tp {mesh}: worst max rel err {worst}")


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_model_ranks_end_bit_equal(tp_runs, mesh):
    """After the step on the case's draws and a second drawing from the
    generator seeded by the data index, every rank's gathered parameters
    are bit-equal, and so are the first step's metrics."""
    first, *rest = tp_runs["ranks"][mesh]
    for other in rest:
        for kind in "gd":
            bad = [k for k, v in first["second"][kind].items()
                   if not torch.equal(v, other["second"][kind][k])]
            assert not bad, (kind, bad[:5])
        for key, v in first["metrics"].items():
            if not key.startswith("debug/"):
                assert torch.equal(v, other["metrics"][key]), key


def test_tp_infer_matches_replicated_infer(tp_runs):
    """``SynthesizerTrn.infer`` with G split over two model ranks against the
    whole G, the same noise: within 1e-5 x peak."""
    for mesh in TP_MESHES:
        for rank in tp_runs["ranks"][mesh]:
            sharded, whole = rank["infer"]
            assert sharded.shape == whole.shape
            peak = float(whole.abs().max())
            assert float((sharded - whole).abs().max()) <= 1e-5 * peak, mesh


@pytest.mark.parametrize("train", [{"zero_opt_state": True}, {"grad_reduce_dtype": "bf16"}])
def test_tp_refuses_what_jax_never_runs_under_it(train):
    """ZeRO-1 moments and the bf16 reduce under tensor parallelism raise
    ValueError, as does the fused K5/K6 discriminator."""
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.parallel.tp import Mesh2D, param_layout
    from quickvc_tpu_torch.parallel.tp_layers import ModelAxis, shard_modules_
    from quickvc_tpu_torch.train.state import create_train_state

    with pytest.raises(ValueError, match="tensor parallelism"):
        create_train_state(configs(**train)[1], torch.device("cpu"),
                           tp=(Mesh2D(1, 2, 0, 0, None, None), 16))
    net_d = MultiPeriodDiscriminator(width=0.25, fused_conv5=True)
    with pytest.raises(ValueError, match="fused K5/K6"):
        shard_modules_(net_d, param_layout(net_d, 2, 16), ModelAxis(None, 2, 0))
