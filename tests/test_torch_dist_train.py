"""PyTorch port, the data-parallel trainer (``python -m quickvc_tpu_torch.train
--distributed``) on the CPU over gloo, the counterpart of
``tests/test_distributed.py:96``, and the trainer options the port used to
refuse:

- two ranks train 2 steps, then resume (mid-epoch) for 2 more, and end with
  checkpoints bit-equal to 4 straight steps, replicated and with ZeRO-1
  moments; rank 1 logs to
  ``train.rank1.log``; rank 0 alone writes checkpoints;
- the distributed entry at world size 1 writes the plain trainer's
  ``G_*.pth`` and ``D_*.pth`` bit for bit;
- ``split_prior``, ``zero_opt_state`` (its checkpoint loading into a plain
  ``AdamW``), ``grad_reduce_dtype: "bf16"`` and two processes each train a
  step;
- several processes (``WORLD_SIZE`` > 1) without ``--distributed`` raise;
- ``--deterministic`` parses, sets torch's and cuDNN's deterministic
  algorithms and cuBLAS's workspace for the run and restores the flags
  after it, and a resume with it stays bit-exact.

The ranks are spawned processes that import no JAX
(``tests/torch_dist_support.py``), meeting through a ``file://``
rendezvous under ``tmp_path``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from test_torch_train_data import write_corpus
from torch_dist_support import spawn
from torch_train_support import configs

import torch_port_support  # noqa: F401  (caps torch's threads)

# 12 utterances of the (40, 50]-frame bucket: 3 global batches of 4 (2 a rank)
# an epoch, so a resume after 2 steps lands mid-epoch
SECONDS = [0.85, 0.9, 0.95, 1.0, 0.88, 0.92, 0.97, 0.86, 0.93, 0.99, 0.87, 0.91]


def _hpfile(tmp_path, **train) -> str:
    listing = write_corpus(tmp_path / "corpus", np.random.default_rng(4), SECONDS)
    held_out = write_corpus(tmp_path / "held_out", np.random.default_rng(5), [0.9, 1.0])
    _, cfg = configs(**({"eval_interval": 2, "epochs": 5} | train))
    cfg.data.training_files, cfg.data.validation_files = listing, held_out
    path = str(tmp_path / "tiny.json")
    cfg.save(path)
    return path


def _args(hpfile: str, root, name: str, steps: int) -> list[str]:
    return ["-c", hpfile, "-m", name, "-mr", str(root), "--device", "cpu",
            "--max-steps", str(steps)]


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _same_checkpoint(a: dict, b: dict) -> bool:
    if a["iteration"] != b["iteration"] or a["learning_rate"] != b["learning_rate"]:
        return False
    if any(not torch.equal(v, b["model"][k]) for k, v in a["model"].items()):
        return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return sa.keys() == sb.keys() and all(torch.equal(sa[i][k], sb[i][k])
                                          for i in sa for k in sa[i])


OPTIONS = {"split_prior": {"split_prior": True}, "zero_opt_state": {"zero_opt_state": True},
           "grad_reduce_bf16": {"grad_reduce_dtype": "bf16"}, "two_processes": {}}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks running, one after another: 2 steps, a resume
    to 4 and 4 straight steps, replicated and with ZeRO-1 moments (the
    checkpoint gathers the ranks' moments, the resume hands each rank its
    shard again); then one step of the "two_processes" option."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    logs = tmp / "logs"
    runs = []
    for mode in ("replicated", "zero1"):
        hpfile = _hpfile(tmp / mode, zero_opt_state=mode == "zero1")
        runs += [_args(hpfile, logs / mode, "resumed", 2), _args(hpfile, logs / mode, "resumed", 4),
                 _args(hpfile, logs / mode, "straight", 4)]
    option = tmp / "two_processes"
    runs.append(_args(_hpfile(option, eval_interval=0), option / "logs", "run", 1))
    ranks = [r["summaries"] for r in spawn("trainer_job", 2, tmp, runs)]
    return {"logs": logs, "ranks": ranks, "option_dir": option}


@pytest.mark.parametrize("mode", ["replicated", "zero1"])
def test_two_ranks_train_resume_and_match_straight_steps(two_ranks, mode):
    at = 0 if mode == "replicated" else 3
    ranks = [r[at : at + 3] for r in two_ranks["ranks"]]
    logs = two_ranks["logs"] / mode
    for first, resumed, straight in ranks:
        assert first["steps"] == 2 and resumed["steps"] == 4 and straight["steps"] == 4
        assert len(resumed["losses"]) == 2 and len(straight["losses"]) == 4
    # the ranks took the same (global) losses
    for a, b in zip(*ranks):
        assert [dict(x, step=0) for x in a["losses"]] == [dict(x, step=0) for x in b["losses"]]
    assert ranks[0][2]["losses"][2:] == ranks[0][1]["losses"]

    run = logs / "resumed"
    for kind in "GD":
        assert _same_checkpoint(_load(run / f"{kind}_4.pth"),
                                _load(logs / "straight" / f"{kind}_4.pth")), kind
    log0, log1 = (run / "train.log").read_text(), (run / "train.rank1.log").read_text()
    assert "Resumed from checkpoint at step 2" in log0 and "Resumed" in log1
    assert "step 3 " in log0 and "step 3 " in log1
    assert "saved" in log0 and "saved" not in log1   # rank 0 alone writes checkpoints
    # after each eval (updates 1 and 3) and at each run's last step
    assert sorted(p.name for p in run.glob("*.pth")) == [
        f"{k}_{n}.pth" for k in "DG" for n in (1, 2, 3, 4)]
    # the eval (after updates 1 and 3) and its event files are rank 0's
    assert [e["step"] for e in ranks[0][2]["evals"]] == [0, 2]
    assert all(not s["evals"] for s in ranks[1])


def test_distributed_entry_at_world_one_writes_the_plain_trainers_checkpoints(tmp_path):
    from quickvc_tpu_torch.train import loop

    hpfile = _hpfile(tmp_path, eval_interval=0)
    logs = tmp_path / "logs"
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                                         rank=0, world_size=1)
    try:
        loop.main(_args(hpfile, logs, "dist", 2) + ["--distributed"])
    finally:
        torch.distributed.destroy_process_group()
    loop.main(_args(hpfile, logs, "plain", 2))
    for kind in "GD":
        assert ((logs / "dist" / f"{kind}_2.pth").read_bytes()
                == (logs / "plain" / f"{kind}_2.pth").read_bytes()), kind


@pytest.mark.parametrize("option", list(OPTIONS))
def test_trainer_options_train_a_step(tmp_path, two_ranks, option):
    """Each JAX-trainer option the port once refused now trains."""
    from quickvc_tpu_torch.train import loop
    from quickvc_tpu_torch.train.state import build_models

    if option == "two_processes":
        summaries = [r[-1] for r in two_ranks["ranks"]]
        run_dir = two_ranks["option_dir"] / "logs" / "run"
    else:
        hpfile = _hpfile(tmp_path, eval_interval=0, **OPTIONS[option])
        summaries = [loop.main(_args(hpfile, tmp_path / "logs", "run", 1))]
        run_dir = tmp_path / "logs" / "run"
    for s in summaries:
        assert s["steps"] == 1 and len(s["losses"]) == 1
        assert all(math.isfinite(v) for v in s["losses"][0].values())
        assert not s["losses"][0]["skipped"]
    ckpt = _load(run_dir / "G_1.pth")
    # the optimizer entry loads into a plain AdamW over the network (ZeRO-1 too)
    _, cfg = configs(**OPTIONS[option])
    net_g, _ = build_models(cfg)
    net_g.load_state_dict(ckpt["model"], strict=True)
    optim = torch.optim.AdamW(net_g.parameters())
    optim.load_state_dict(ckpt["optimizer"])
    for p in net_g.parameters():
        assert optim.state[p]["exp_avg"].shape == p.shape


def test_several_processes_without_distributed_raise(tmp_path, monkeypatch):
    from quickvc_tpu_torch.train import loop

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="--distributed"):
        loop.main(["-mr", str(tmp_path), "--device", "cpu", "--max-steps", "1"])


def test_deterministic_flag_sets_and_restores_the_flags(monkeypatch):
    from quickvc_tpu_torch.train import loop

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert loop.parse_args(["--deterministic"]).deterministic
    assert not loop.parse_args([]).deterministic
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    with loop.deterministic_algorithms(True):
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == before
    with loop.deterministic_algorithms(False):
        assert torch.are_deterministic_algorithms_enabled() == before[0]


def test_deterministic_resume_equals_straight_steps(tmp_path, monkeypatch):
    """With ``--deterministic``: 2 steps, then a resume to 4, write the same
    ``G_4.pth`` and ``D_4.pth`` bytes as 4 straight steps."""
    from quickvc_tpu_torch.train import loop

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    hpfile = _hpfile(tmp_path, eval_interval=0)
    logs = tmp_path / "logs"
    for name, steps in (("resumed", 2), ("resumed", 4), ("straight", 4)):
        out = loop.main(_args(hpfile, logs, name, steps) + ["--deterministic"])
        assert out["steps"] == steps
    assert "Resumed from checkpoint at step 2" in (logs / "resumed" / "train.log").read_text()
    for kind in "GD":
        assert ((logs / "resumed" / f"{kind}_4.pth").read_bytes()
                == (logs / "straight" / f"{kind}_4.pth").read_bytes()), kind
