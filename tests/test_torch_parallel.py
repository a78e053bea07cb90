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
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_dist_support import spawn
from torch_train_support import FRAMES, TINY, configs, max_rel_err

import torch_port_support  # noqa: F401  (caps torch's threads)

ROWS = 4   # the global batch: two rows a rank
VARIANTS = {"f32": {}, "zero": {"zero_opt_state": True},
            "split_bf16": {"split_prior": True, "grad_reduce_dtype": "bf16"}}
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


def _jax_sharded_step():
    """JAX's shard_map step (split_prior, bf16 reduce, the same key on both
    shards) on a 2-device mesh, with each shard's draws recovered."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quickvc_tpu.dsp.mel import mel_filterbank
    from quickvc_tpu.dsp.stft import spec_to_mel, wave_to_spec_halo
    from quickvc_tpu.parallel import data_parallel_mesh, make_sharded_train_step
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
    mesh = data_parallel_mesh(2)
    step = make_sharded_train_step(jcfg, net_g, net_d, basis, mesh, reduce_dtype=jnp.bfloat16,
                                   per_shard_rng=False, debug_grads=True)
    new_state, metrics = jax.device_get(step(
        jax.device_put(state, NamedSharding(mesh, P())),
        jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       NamedSharding(mesh, P("data"))), rng))

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
    return case, metrics, new_state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference, the two ranks' steps of every variant, and one
    process's float32 step on the whole batch."""
    from torch_dist_support import _case_state

    from quickvc_tpu_torch.train.step import mel_basis, train_step

    tmp = tmp_path_factory.mktemp("dp")
    case, jax_metrics, jax_state = _jax_sharded_step()
    torch.save(case, tmp / "case.pt")
    ranks = spawn("step_job", 2, tmp, VARIANTS)

    def one_process(**train):
        state = _case_state(case, **train)
        batch = {k: torch.from_numpy(v.copy()) for k, v in case["batch"].items()}
        with torch.backends.mkldnn.flags(enabled=False):
            m = train_step(state, batch, mel_basis(state.cfg, torch.device("cpu")),
                           eps_q=torch.from_numpy(case["eps_q"].copy()),
                           ids_slice=torch.from_numpy(case["ids"].copy()), debug_grads=True)
        return state, m

    return {"case": case, "jax_metrics": jax_metrics, "jax_state": jax_state, "ranks": ranks,
            "one_process": one_process}


def test_dp_step_matches_one_process_on_the_global_batch(runs):
    _, single = runs["one_process"]()
    ours = runs["ranks"][0]["f32"]["metrics"]
    for key in LOSSES + ("grad_norm/d", "grad_norm/g"):
        np.testing.assert_allclose(float(ours[key]), float(single[key]), rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    for key in ("loss/g", "loss/d/r", "loss/d/g"):
        np.testing.assert_allclose(ours[key].numpy(), single[key].numpy(), rtol=2e-4,
                                   atol=1e-4, err_msg=key)
    for kind in ("debug/d_grads", "debug/g_grads"):
        err, where = max_rel_err(ours[kind], {k: v.numpy() for k, v in single[kind].items()})
        assert err < 2e-3, f"{kind}: rel {err} at {where}"


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
