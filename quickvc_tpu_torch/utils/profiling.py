"""Tracing and timing harness (port of ``quickvc_tpu/utils/profiling.py``).

- :func:`trace` (``log_dir``): a context manager around ``torch.profiler``
  with CPU and, where a card is present, CUDA activity. On the way out it
  writes one Chrome-trace JSON into ``log_dir`` (``*.pt.trace.json``, named
  by host and process, or by rank under a process group), which Perfetto
  (ui.perfetto.dev) and ``chrome://tracing`` open.
- :func:`timed` (``fn, *args, iters``): wall seconds of ``iters`` calls
  after one warm call, the output's cards synchronized before each clock
  read (JAX's ``block_until_ready`` on every output).
- :func:`time_chained` (``fn, iters, *args``): wall seconds of ``iters``
  serialized runs of ``fn(carry, *args)``, each carry computed from the
  last output, one synchronize at the end.
- The trainer's ``--profile-steps N`` (``train/loop.py``) traces the steps
  whose update counter is 5 ... 4 + N into ``model_dir/profile``.

A trace shows the device records CUPTI delivered: ``trace`` keeps the
block clear of the records a late-started profiler loses, and the
LSTM cluster kernels' device times are read from CUDA events (their
profiler times have read half of them before, ``PERF.md``).
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
import time

import torch


# tiny kernels launched in the profiler's warm-up stage, and the card's idle
# time once it records, before the traced block (see trace)
WARMUP_LAUNCHES, IDLE_SECONDS = 512, 0.02


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler``; write the Chrome trace into
    ``log_dir`` when the block ends, whether it ends normally or not.

    On an H100, a trace started after ten minutes of one process held no
    device record for the first 57 of its 25,344 kernel launches (their
    host-side launches were there), and its device records sat up to 2.3 ms
    before their launches on the trace's clock; one started after a few
    minutes held them all (``chip_smoke.py`` phase 18, ``PERF.md``, PR 22).
    So the profiler starts in its warm-up stage, WARMUP_LAUNCHES tiny
    kernels run there (what that stage records is discarded), and it
    records from the next stage on, the card idle for IDLE_SECONDS before
    the block and synchronized after it."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    worker = None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        worker = f"{socket.gethostname()}_rank{torch.distributed.get_rank()}"
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    cuda = torch.cuda.is_initialized()   # a process that has touched a card
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir, worker_name=worker)) as prof:
        if cuda:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize()
        prof.step()
        time.sleep(IDLE_SECONDS)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()


def _block_until_ready(out) -> None:
    """Synchronize every card that holds a tensor of ``out`` (nested lists,
    tuples and dicts)."""
    stack, cards = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                cards.add(x.device)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    for card in cards:
        torch.cuda.synchronize(card)


def timed(fn, *args, iters: int = 1):
    """(seconds, last_output) for ``iters`` sequential calls, fully synced."""
    out = fn(*args)
    _block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _block_until_ready(out)
    return time.perf_counter() - t0, out


def time_chained(fn, iters: int, *args) -> float:
    """Seconds for ``iters`` serialized runs of ``fn(carry, *args)``.

    Each run's input depends on the last one's output: the carry is the
    output's float32 mean times 1e-12 (a float32 scalar on the device of
    the first tensor argument; zero for the first run), so no run can start
    before the one before it has finished, and the numbers are unperturbed.
    One synchronize at the end, by reading the last carry on the host. One
    untimed pass, then the fastest of two timed ones, as the JAX version
    (whose ``lax.scan`` guarded against a remote runtime returning before
    the work was done) takes them.
    """
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))

    def chained() -> float:
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            carry = fn(carry, *args).float().mean() * 1e-12
        return float(carry)

    chained()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        val = chained()
        best = min(best, time.perf_counter() - t0)
        assert math.isfinite(val)
    return best
