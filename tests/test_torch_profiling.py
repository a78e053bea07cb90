"""PyTorch port, the tracing and timing harness (``utils/profiling.py``) and
the trainer's ``--profile-steps``.

``trace`` writes one Chrome trace holding the block's ``record_function``
spans, also when the block raises; ``timed`` calls ``fn`` once to warm up
and ``iters`` times timed; ``time_chained`` feeds each run's carry (the
last output's mean times 1e-12, float32) into the next. The trainer CLI on
the CPU at the tiny config of ``tests/torch_train_support.py:configs``
traces the steps whose update counter is 5 ... 4 + N (one
``quickvc_train_step`` span each) into ``model_dir/profile``, stops the
trace when the counter reaches 5 + N, writes it on the way out when the run
ends inside the window, traces nothing with ``--profile-steps 0`` or when a
resumed run starts past 5.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import torch_port_support  # noqa: F401  (caps torch's CPU threads)

STEP_SPAN = "quickvc_train_step"


def traces(log_dir) -> list:
    return sorted(log_dir.glob("*.pt.trace.json")) if log_dir.exists() else []


def spans(path, name: str) -> list[dict]:
    """The host-side ``record_function`` spans called ``name`` in a Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    from quickvc_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "a")):
        with torch.profiler.record_function("qvc_test_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = traces(tmp_path / "a")
    assert len(spans(path, "qvc_test_span")) == 1
    with pytest.raises(ZeroDivisionError), trace(str(tmp_path / "b")):
        with torch.profiler.record_function("qvc_test_span"):
            1 / 0
    (path,) = traces(tmp_path / "b")
    assert len(spans(path, "qvc_test_span")) == 1


@pytest.mark.parametrize("iters", [1, 4])
def test_timed_warms_up_once_then_times_iters_calls(iters):
    from quickvc_tpu_torch.utils.profiling import timed

    calls = []

    def fn(x):
        calls.append(x)
        return [{"y": x * len(calls)}]

    seconds, out = timed(fn, torch.ones(3), iters=iters)
    assert len(calls) == iters + 1 and seconds >= 0
    assert torch.equal(out[0]["y"], torch.full((3,), float(iters + 1)))


def test_time_chained_feeds_each_carry_into_the_next_run():
    from quickvc_tpu_torch.utils.profiling import time_chained

    carries, outs = [], []

    def fn(carry, x):
        carries.append(carry)
        outs.append(x * (len(carries) + 1) + carry)
        return outs[-1]

    seconds = time_chained(fn, 3, torch.arange(4, dtype=torch.float32))
    assert np.isfinite(seconds) and seconds >= 0
    assert len(carries) == 9   # one untimed pass and two timed ones, 3 runs each
    for run in range(3):
        first = carries[3 * run]
        assert first.dtype == torch.float32 and first.shape == () and float(first) == 0
        for k in range(1, 3):
            assert torch.equal(carries[3 * run + k], outs[3 * run + k - 1].mean() * 1e-12)


@pytest.fixture(scope="module")
def five_steps(tmp_path_factory):
    """Five steps (counters 0-4) of the trainer at the tiny config with
    ``--profile-steps 0``; the CLI arguments of its run."""
    from test_torch_train_data import write_corpus
    from torch_train_support import configs

    from quickvc_tpu_torch.config import config_from_dict
    from quickvc_tpu_torch.train import loop

    tmp = tmp_path_factory.mktemp("profile")
    _, cfg = configs(eval_interval=0)
    d = cfg.to_dict()
    d["data"]["training_files"] = d["data"]["validation_files"] = write_corpus(
        tmp / "corpus", np.random.default_rng(4), [0.9, 0.95, 1.0, 0.85])
    config_from_dict(d).save(str(tmp / "tiny.json"))
    args = ["-c", str(tmp / "tiny.json"), "-m", "run", "-mr", str(tmp / "logs"),
            "--device", "cpu"]
    out = loop.main(args + ["--max-steps", "5", "--profile-steps", "0"])
    assert out["steps"] == 5
    return tmp, args


def _resume(tmp_path, five_steps, flags):
    """A copy of the five-step run, resumed at counter 5 with ``flags``."""
    from quickvc_tpu_torch.train import loop

    tmp, args = five_steps
    shutil.copytree(tmp / "logs", tmp_path / "logs")
    args = args[:5] + [str(tmp_path / "logs")] + args[6:]
    return loop.main(args + flags), tmp_path / "logs" / "run"


def test_profile_steps_zero_writes_no_profile(five_steps):
    tmp, _ = five_steps
    assert not (tmp / "logs" / "run" / "profile").exists()


@pytest.mark.parametrize("max_steps,n,traced", [
    (6, 1, 1),    # the step whose counter is 5; the run ends with the window
    (8, 2, 2),    # counters 5 and 6; stopped when counter 7's batch comes, which is untraced
    (7, 3, 2)])   # the run ends inside the window [5, 8): the trace is written on the way out
def test_profile_steps_trace_the_window(tmp_path, five_steps, max_steps, n, traced):
    out, run_dir = _resume(tmp_path, five_steps, ["--max-steps", str(max_steps),
                                                  "--profile-steps", str(n)])
    assert out["steps"] == max_steps and len(out["step_seconds"]) == max_steps - 5
    (path,) = traces(run_dir / "profile")
    assert len(spans(path, STEP_SPAN)) == traced
    log = (run_dir / "train.log").read_text()
    assert f"tracing steps 5-{4 + n} into" in log and "profile trace written to" in log
    if max_steps > 5 + n:   # written before the first untraced step's log line
        assert log.index("profile trace written to") < log.index(f"step {5 + n + 1} lr")
    # resumed with its counter past 5: nothing more is traced
    from quickvc_tpu_torch.train import loop

    loop.main(["-c", str(five_steps[0] / "tiny.json"), "-m", "run", "-mr",
               str(tmp_path / "logs"), "--device", "cpu", "--max-steps", str(max_steps + 1),
               "--profile-steps", "2"])
    assert traces(run_dir / "profile") == [path]
