"""Command-line probes and benchmarks of the port.

Run as ``python -m quickvc_tpu_torch.scripts.<name>``.
"""

from __future__ import annotations

import time

import torch


def time_ms(fn, device: torch.device, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` after ``warmup`` calls: CUDA
    events around ``iters`` calls on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters
