"""PyTorch port, the rest of the training loop: ``evaluate`` and ``_pad_frames``
against the JAX package's on the same weights and eval items, and the
trainer CLI on the CPU at the tiny config (event files, the eval points,
exports and checkpoint pruning, the exit-75 host-memory restart and its exact
resume, process-mode loaders, ``--init-from-torch``).

Tolerances are the model tests' (tests/test_torch_models.py): scalars atol
1e-4 / rtol 1e-3, waves within 1e-3 x max|reference|.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_logging import accumulator  # noqa: F401  (a fixture)
from test_torch_train_data import write_corpus
from torch_train_support import configs

REPO = Path(__file__).resolve().parents[1]
EVAL_SECONDS = [1.02, 1.12, 1.27]   # 51, 56 and 63 frames: reflect-padded to one 100-frame bucket


class RecordingWriter:
    """Stands in for a Summarizer: keeps what each call was given."""

    def __init__(self):
        self.scalar, self.image, self.audio = {}, {}, {}

    def scalars(self, step, values):
        self.scalar.update({k: (step, float(v)) for k, v in values.items()})

    def images(self, step, values):
        self.image.update({k: (step, np.asarray(v)) for k, v in values.items()})

    def audios(self, step, values, sr):
        self.audio.update({k: (step, np.asarray(v, np.float32).reshape(-1)) for k, v in
                           values.items()})

    def histograms(self, step, values):
        pass

    def flush(self):
        pass


@pytest.mark.parametrize("rows,target,ndim", [
    (1, 50, 2), (2, 50, 2), (5, 50, 2), (46, 50, 2), (63, 100, 2), (50, 50, 2), (3, 8, 1),
    (1, 4, 1)])
def test_pad_frames_matches_jax(rows, target, ndim):
    from quickvc_tpu.train.loop import _pad_frames as jax_pad
    from quickvc_tpu_torch.train.loop import _pad_frames

    x = np.random.default_rng(rows).standard_normal((rows, 3)[:ndim]).astype(np.float32)
    ours, theirs = _pad_frames(x, target), jax_pad(x, target)
    assert ours.shape[0] == max(rows, target)
    np.testing.assert_array_equal(ours, theirs)


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    """Three eval items of two speakers through both evals on the same
    weights: the four eval/* scalars, the conversion targets, the
    resynthesised and converted waves. The JAX eval renders its images with
    the port's renderer (no matplotlib): images are not compared."""
    import jax
    import jax.numpy as jnp

    from quickvc_tpu.data.dataset import UnitAudioSpecDataset as JaxDataset
    from quickvc_tpu.dsp.mel import mel_filterbank
    from quickvc_tpu.models.encoders import embed_utterance_batch
    from quickvc_tpu.train import loop as jax_loop
    from quickvc_tpu.train.state import build_models
    from quickvc_tpu_torch.data.dataset import UnitAudioSpecDataset
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.train.loop import evaluate
    from quickvc_tpu_torch.train.step import mel_basis
    from quickvc_tpu_torch.utils.logging import plot_spectrogram
    from quickvc_tpu_torch.utils.weights import generator_state_dict_from_jax
    from torch_port_support import random_params

    listing = write_corpus(tmp_path / "eval", np.random.default_rng(11), EVAL_SECONDS)
    jcfg, cfg = configs()
    jcfg.data.validation_files = cfg.data.validation_files = listing
    net_g, _ = build_models(jcfg)
    key = jax.random.PRNGKey(0)
    g_params = random_params(net_g, 3, {"params": key, "sample": key, "slice": key},
                             jnp.zeros((1, 16, 12)), jnp.zeros((1, 16, 641)),
                             jnp.zeros((1, 16, 80)))
    jbasis = jnp.asarray(mel_filterbank(16000, 1280, 80))
    jds = JaxDataset("eval", jcfg)
    monkeypatch.setattr(jax_loop, "plot_spectrogram", plot_spectrogram)
    theirs = RecordingWriter()
    jax_l1 = jax_loop.evaluate(5, jcfg, net_g, type("S", (), {"g_params": g_params}), jds,
                               jbasis, theirs)

    # the JAX eval's conversion targets, from its own embed program on its padded mels
    fns = jax_loop._eval_fns(jcfg, net_g, jbasis)
    g_vecs = []
    for i in range(len(jds)):
        item = jds[i]
        n = min(item["unit"].shape[0], item["spec"].shape[0])
        spec = jax_loop._pad_frames(item["spec"][:n], -(-n // 50) * 50)[None]
        g = embed_utterance_batch(fns["embed"], {"params": g_params}, fns["mel"](spec))
        g_vecs.append(np.asarray(g).reshape(-1))
    g_unit = np.stack(g_vecs) / (np.linalg.norm(g_vecs, axis=1, keepdims=True) + 1e-8)
    cos = g_unit @ g_unit.T
    np.fill_diagonal(cos, np.inf)
    jax_targets = [int(j) for j in np.argmin(cos, axis=1)]

    net = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
    net.load_state_dict(generator_state_dict_from_jax(g_params, cfg.model), strict=True)
    net.train()
    ours = RecordingWriter()
    result = evaluate(5, cfg, net, UnitAudioSpecDataset("eval", cfg),
                      mel_basis(cfg, torch.device("cpu")), ours)
    assert net.training  # its mode restored

    assert result["vc_targets"] == jax_targets and len(set(jax_targets)) > 1
    names = ("eval/mel_l1", "eval/spk_sim", "eval/vc_spk_sim", "eval/vc_spk_margin")
    assert set(ours.scalar) == set(theirs.scalar) == set(names)
    for k in names:
        assert ours.scalar[k][0] == theirs.scalar[k][0] == 5
        np.testing.assert_allclose(ours.scalar[k][1], theirs.scalar[k][1], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
        assert result["scalars"][k] == ours.scalar[k][1]
    np.testing.assert_allclose(result["scalars"]["eval/mel_l1"], jax_l1, rtol=1e-3, atol=1e-4)
    assert set(ours.audio) == set(theirs.audio)
    assert set(ours.image) == set(theirs.image) == {
        f"{kind}/mel_{i}" for kind in ("gen", "gt") for i in range(3)}
    for k, (_, ref) in theirs.audio.items():
        got = ours.audio[k][1]
        assert got.shape == ref.shape, k
        if k.startswith("gt/"):
            np.testing.assert_array_equal(got, ref)
        else:
            assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), k


def tiny_run(tmp_path, **train):
    """A corpus of four training utterances (two batches an epoch) and the
    three eval items; returns the CLI's arguments for a run on the CPU."""
    from quickvc_tpu_torch.config import config_from_dict

    _, cfg = configs(**train)
    d = cfg.to_dict()
    d["data"]["training_files"] = write_corpus(tmp_path / "corpus", np.random.default_rng(4),
                                               [0.9, 0.95, 1.0, 0.85])
    d["data"]["validation_files"] = write_corpus(tmp_path / "eval", np.random.default_rng(11),
                                                 EVAL_SECONDS)
    hpfile = tmp_path / "tiny.json"
    config_from_dict(d).save(str(hpfile))
    return ["-c", str(hpfile), "-m", "run", "-mr", str(tmp_path / "logs"), "--device", "cpu"]


def steps_on_disk(run_dir) -> list[int]:
    return sorted(int(p.stem[2:]) for p in run_dir.glob("G_*.pth")
                  if (run_dir / f"D_{p.stem[2:]}.pth").exists())


@pytest.mark.parametrize("export_from", ["config", "flag"])
def test_trainer_logs_evaluates_and_exports(tmp_path, export_from, accumulator):
    """Five steps: TensorBoard events in model_dir and model_dir/eval, eval
    after updates 1, 3 and 5 (steps 0, 2, 4 in TensorBoard), exports after
    updates 1 and 4 kept by the pruning to one other pair."""
    from quickvc_tpu_torch.train import loop

    args = tiny_run(tmp_path, eval_interval=2, ckpt_max_to_keep=1,
                    export_torch_every=3 if export_from == "config" else 2)
    flag = ["--export-torch-every", "3"] if export_from == "flag" else []
    out = loop.main(args + flag + ["--max-steps", "5"])
    run_dir = tmp_path / "logs" / "run"
    assert [e["step"] for e in out["evals"]] == [0, 2, 4] and len(out["log_seconds"]) == 5
    assert steps_on_disk(run_dir) == [1, 4, 5]   # pair 3 pruned, exports 1 and 4 kept
    assert "exported reference-layout G_4.pth/D_4.pth" in (run_dir / "train.log").read_text()

    train = accumulator(run_dir)
    tags = train.Tags()
    assert {"loss/g/total", "loss/d/total", "loss/g/mel", "loss/g/kl", "loss/g/fm",
            "loss/g/gen", "loss/g/0", "loss/d/r/0", "grad_norm/g", "time/step_p50",
            "time/step_p95", "time/step_max", "host/rss_gb"} <= set(tags["scalars"])
    assert set(tags["images"]) == {"slice/mel_org", "slice/mel_gen", "all/mel"}
    assert [e.step for e in train.Scalars("loss/g/total")] == [0, 1, 2, 3, 4]
    np.testing.assert_allclose([e.value for e in train.Scalars("loss/g/total")],
                               [s["g/total"] for s in out["losses"]], rtol=1e-6)
    ev = accumulator(run_dir / "eval")
    tags = ev.Tags()
    assert set(tags["scalars"]) == {"eval/mel_l1", "eval/spk_sim", "eval/vc_spk_sim",
                                    "eval/vc_spk_margin"}
    assert [e.step for e in ev.Scalars("eval/mel_l1")] == [0, 2, 4]
    assert set(tags["images"]) == {f"{k}/mel_{i}" for k in ("gen", "gt") for i in range(3)}
    assert set(tags["audio"]) == {f"{k}/audio_{i}" for k in ("gen", "gt") for i in range(3)} | {
        "vc/audio_0"}


def test_host_memory_restart_exits_75_and_resumes_exactly(tmp_path):
    """max_host_rss_gb below any process's RSS: ``main`` checkpoints after
    the first update and exits 75 (process-mode loaders); each relaunch
    (thread loaders) resumes and takes one more; the third pair equals an
    uninterrupted three-step run's, weights and AdamW moments."""
    import json

    from quickvc_tpu_torch.train import loop

    args = tiny_run(tmp_path, max_host_rss_gb=1e-6, eval_interval=0, loader_mode="process",
                    loader_workers=1)
    run_dir = tmp_path / "logs" / "run"
    hp = json.loads((tmp_path / "tiny.json").read_text())
    for step in (1, 2, 3):
        with pytest.raises(SystemExit) as exit_info:
            loop.main(args + ["--max-steps", "3"])
        assert exit_info.value.code == 75 and steps_on_disk(run_dir)[-1] == step
        hp["train"]["loader_mode"] = "thread"
        (tmp_path / "tiny.json").write_text(json.dumps(hp))
    log = (run_dir / "train.log").read_text()
    assert "requesting restart" in log and "Resumed from checkpoint at step 2" in log

    hp["train"]["max_host_rss_gb"] = 0.0
    (tmp_path / "tiny.json").write_text(json.dumps(hp))
    straight = loop.main(["-c", args[1], "-m", "straight", "-mr", str(tmp_path / "logs"),
                          "--device", "cpu", "--max-steps", "3"])
    assert straight["steps"] == 3
    for kind in "GD":
        a, b = (torch.load(tmp_path / "logs" / name / f"{kind}_3.pth", weights_only=True)
                for name in ("run", "straight"))
        assert a["model"].keys() == b["model"].keys()
        assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]), kind
        for s_a, s_b in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
            assert all(torch.equal(s_a[k], s_b[k]) for k in s_a), kind


def test_init_from_torch_warm_starts(tmp_path):
    """Reference-layout G and D load exactly, with fresh optimizers and the
    step counter at G's iteration; a pair in model_dir then wins (a resume);
    three paths are a usage error."""
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.train import loop
    from quickvc_tpu_torch.train.state import build_models
    from quickvc_tpu_torch.utils.weights import init_random_

    args = tiny_run(tmp_path, eval_interval=0)
    cfg = load_config(args[1])
    net_g, net_d = build_models(cfg)
    init_random_(net_g, 77)
    init_random_(net_d, 78)
    g_pth, d_pth = tmp_path / "G_ref.pth", tmp_path / "D_ref.pth"
    torch.save({"model": net_g.state_dict(), "iteration": 7, "optimizer": None,
                "learning_rate": 2e-4}, g_pth)
    torch.save({"model": net_d.state_dict(), "iteration": 7}, d_pth)

    cfg.model_dir = str(tmp_path / "warm")
    state = loop._initial_state(cfg, torch.device("cpu"), (str(g_pth), str(d_pth)),
                                loop.get_logger(cfg.model_dir))
    assert state.step == 7 and not state.optim_g.state and not state.optim_d.state
    for ours, ref in ((state.net_g, net_g), (state.net_d, net_d)):
        sd = ours.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in ref.state_dict().items())

    out = loop.main(args + ["--init-from-torch", str(g_pth), str(d_pth), "--max-steps", "8"])
    assert [s["step"] for s in out["losses"]] == [8]
    out = loop.main(args + ["--init-from-torch", str(g_pth), "--max-steps", "9"])
    assert [s["step"] for s in out["losses"]] == [9]
    log = (tmp_path / "logs" / "run" / "train.log").read_text()
    assert "Warm-started from torch checkpoint" in log
    assert "Resumed from checkpoint at step 8" in log
    with pytest.raises(SystemExit):
        loop.parse_args(["--init-from-torch", "a", "b", "c"])
