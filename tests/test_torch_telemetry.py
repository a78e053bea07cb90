"""PyTorch port, training telemetry (``quickvc_tpu_torch/train/telemetry.py``)
against the JAX package's: the same wall sequences give the same stall
flags, running medians and percentile summaries; the watchdog warns on
frozen progress; the restart exit code is the JAX module's and the
supervisor's. No JAX is imported (the JAX telemetry module is host-only).
"""

import logging
import runpy
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _walls(kind: str) -> list[float]:
    rng = np.random.default_rng(3)
    if kind == "steady_with_stalls":
        w = list(rng.uniform(0.9, 1.1, 120))
        w[40], w[90] = 270.0, 6.0
        return w
    if kind == "slow_regime":      # the threshold follows the running median
        return [4.0] * 30 + [12.0, 25.0] + [4.0] * 10
    if kind == "warmup_compile":   # a long first-shape step inside the warmup
        return [40.0 if i == 3 else 0.1 for i in range(30)] + [0.6]
    return list(rng.lognormal(0.0, 0.6, 400))   # heavy-tailed, past the median window


@pytest.mark.parametrize("kind", ["steady_with_stalls", "slow_regime", "warmup_compile",
                                  "lognormal_long"])
def test_tracker_matches_jax(kind):
    from quickvc_tpu.train.telemetry import StepWallTracker as JaxTracker
    from quickvc_tpu_torch.train.telemetry import StepWallTracker

    ours, theirs = StepWallTracker(warmup=10), JaxTracker(warmup=10)
    for i, w in enumerate(_walls(kind)):
        assert ours.add(w) == theirs.add(w), i
        assert ours.median() == theirs.median(), i
        if i % 17 == 0:
            assert ours.summary() == theirs.summary(), i
    assert ours.summary() == theirs.summary()
    assert (ours.stalls, ours.total_steps) == (theirs.stalls, theirs.total_steps)
    if kind == "steady_with_stalls":
        assert ours.stalls == 2


def test_watchdog_warns_on_frozen_progress():
    from quickvc_tpu_torch.train.telemetry import StepWallTracker

    t = StepWallTracker(warmup=1)
    t.add(0.01)
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("torch-watchdog-test")
    logger.addHandler(Capture())
    logger.setLevel(logging.WARNING)
    stop = t.watchdog(logger, lambda: t.total_steps, interval=0.05, factor=1.0, floor=0.1)
    try:
        time.sleep(1.0)   # no progress the whole time
    finally:
        stop.set()
    assert any("watchdog: no training progress" in m for m in records)


def test_restart_exit_code_matches_jax_and_supervisor():
    from quickvc_tpu.train import telemetry as jax_telemetry
    from quickvc_tpu_torch.train import telemetry

    supervisor = runpy.run_path(str(REPO / "scripts" / "supervise_train.py"), run_name="x")
    assert (telemetry.RESTART_EXIT_CODE == jax_telemetry.RESTART_EXIT_CODE
            == supervisor["RESTART_EXIT_CODE"] == 75)
    err = telemetry.HostMemoryRestart(9.5, 8.0, 12)
    assert (err.rss_gb, err.limit_gb, err.step) == (9.5, 8.0, 12) and "75" in str(err)
    assert 0.0 < telemetry.host_rss_gb() < 1024
