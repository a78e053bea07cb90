"""Step-wall telemetry: per-step wall-time percentiles, stall detection, the
host-memory restart request.

The port's own copy of ``quickvc_tpu/train/telemetry.py`` (the reference
logs nothing about step timing, its train.py:165-179 logs losses only).
The port's loop synchronises with the card at the end of every step, so it
feeds :class:`StepWallTracker` each step's wall directly: batch upload,
step and the metrics read, with eval, logging and checkpoint time left out.
The tracker keeps

- a bounded window of recent walls for a *running median* (robust to the
  occasional stall entering the window), and
- the walls since the last log flush, summarized to p50/p95/max scalars
  (``time/step_p50`` etc.) for TensorBoard.

A step is flagged as a stall when it exceeds ``stall_factor`` x the running
median, after ``warmup`` samples exist (the first steps of every new bucket
shape pay cuDNN's set-up and are flagged thereafter: a mid-run set-up is a
stall from the run's perspective).

This module imports no torch.
"""

from __future__ import annotations

from collections import deque

#: Process exit code meaning "checkpointed cleanly, relaunch me"
#: (BSD EX_TEMPFAIL). ``python -m quickvc_tpu_torch.train`` exits with it on
#: HostMemoryRestart; scripts/supervise_train.py relaunches any command
#: while it returns this code.
RESTART_EXIT_CODE = 75


class HostMemoryRestart(RuntimeError):
    """Raised by the train loop after it has CHECKPOINTED, when host RSS
    crossed ``train.max_host_rss_gb``. Not an error: resume is exact, so
    the loss-free mitigation for any host-side leak is a periodic restart.
    The trainer's CLI converts this into ``RESTART_EXIT_CODE``.
    """

    def __init__(self, rss_gb: float, limit_gb: float, step: int):
        super().__init__(
            f"host RSS {rss_gb:.2f} GB > train.max_host_rss_gb "
            f"{limit_gb:.2f} GB at step {step}; checkpoint saved — "
            f"relaunch to resume (exit code {RESTART_EXIT_CODE} under "
            f"python -m quickvc_tpu_torch.train; scripts/supervise_train.py "
            f"automates the relaunch)")
        self.rss_gb = rss_gb
        self.limit_gb = limit_gb
        self.step = step


def host_rss_gb() -> float:
    """Resident set size of THIS process in GiB.

    /proc/self/status VmRSS on Linux (one small read, no allocation churn —
    safe at log-interval cadence); ru_maxrss fallback elsewhere (a peak,
    not current — still monotone enough for a restart threshold).
    """
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / (1024 * 1024)  # kB -> GiB
    except OSError:
        pass
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # Linux reports kB, macOS bytes
    return ru / (1024 * 1024) if ru < 1 << 40 else ru / (1 << 30)


class StepWallTracker:
    def __init__(self, stall_factor: float = 5.0, median_window: int = 200,
                 warmup: int = 20):
        self.stall_factor = stall_factor
        self.warmup = warmup
        self._recent: deque[float] = deque(maxlen=median_window)
        self._since_log: list[float] = []
        self.stalls = 0          # lifetime count of flagged stalls
        self.total_steps = 0

    def median(self) -> float | None:
        """Running median, or None before warmup (watchdog threshold)."""
        return self._median() if len(self._recent) >= self.warmup else None

    def _median(self) -> float:
        xs = sorted(self._recent)
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def add(self, dt: float) -> float | None:
        """Record one step's wall time.

        Returns the running median if this step is a stall (caller logs the
        warning with it), else None. The stalled sample still enters both
        windows — the median is robust to it, and hiding it from the
        percentiles would defeat their purpose.
        """
        stall_median = None
        if len(self._recent) >= self.warmup:
            med = self._median()
            if med > 0 and dt > self.stall_factor * med:
                stall_median = med
                self.stalls += 1
        self._recent.append(dt)
        self._since_log.append(dt)
        self.total_steps += 1
        return stall_median

    def watchdog(self, logger, get_progress, interval: float = 30.0,
                 factor: float = 20.0, floor: float = 300.0):
        """Daemon thread that WARNs when no progress happens for a long time.

        The stall detector above only sees COMPLETED steps: a full wedge (a
        hung card, a deadlocked loader) produces no samples and stays
        invisible. The watchdog compares wall time since the last observed
        progress value change against max(floor, factor x running median x
        4) (the JAX loop's sync window, kept so both warn alike) and logs a
        WARNING (repeating with backoff) while the loop is frozen.
        Observability only: it never kills anything; the floor (300 s)
        sits above the kernels' first build, so startup is quiet.

        ``get_progress`` returns any value that changes when the loop makes
        progress (e.g. the tracker's ``total_steps``). Returns a
        ``threading.Event``; the owning loop MUST ``set()`` it when done
        (run() does, in a finally) — otherwise the thread outlives the run
        and warns about a tracker that is merely finished, not wedged.
        """
        import threading
        import time as _time

        stop = threading.Event()

        def body():
            last = get_progress()
            t_last = _time.monotonic()
            warned = 0
            while not stop.wait(interval):
                cur = get_progress()
                if cur != last:
                    last, t_last, warned = cur, _time.monotonic(), 0
                    continue
                frozen = _time.monotonic() - t_last
                med = self.median()
                limit = max(floor, factor * (med or 0.0) * 4)
                if frozen > limit * (2 ** warned):
                    logger.warning(
                        "watchdog: no training progress for %.0f s "
                        "(running median %s s/step) — pipeline wedged?",
                        frozen, f"{med:.2f}" if med is not None else "n/a")
                    warned += 1

        threading.Thread(target=body, daemon=True,
                         name="stepwall-watchdog").start()
        return stop

    def summary(self) -> dict[str, float]:
        """Percentile scalars over the steps since the last summary; resets
        the log window (the running-median window is untouched)."""
        xs = sorted(self._since_log)
        self._since_log = []
        if not xs:
            return {}
        n = len(xs)
        return {
            "time/step_p50": xs[int(0.50 * (n - 1))],
            "time/step_p95": xs[int(0.95 * (n - 1))],
            "time/step_max": xs[-1],
        }
