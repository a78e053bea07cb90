"""Live-conversion latency benchmark of the port: the step time of a live session's tick.

Port of ``scripts/realtime_bench.py``. At the full width of the default
configuration with the full HuBERT-soft and seeded random weights, it times
the step of ``quickvc_tpu_torch.infer.realtime`` sessions: synthesis alone
(unit-domain sessions) and HuBERT-soft plus synthesis (wave-domain
sessions). For each point (domain, N concurrent streams, chunk, lookahead)
it prints one JSON line:

- ``step_ms``: device time per tick on a window of seeded random data (CUDA
  events around ``--iters`` steps after warm-up; the host clock with
  ``--device cpu``, where every kernel takes its plain version);
- ``rtf``: step time over the chunk's duration (< 1 is real time);
- ``latency_ms``: mouth-to-ear, chunk + lookahead + step;
- ``launches_per_tick``: the port's kernel launches in one step.

A point is real-time when step_ms < the chunk's duration; the largest such N
is the card's live-stream capacity at that latency. ``--precision bf16``
(the default, as the JAX benchmark's) runs the sessions' steps in bf16 as
the JAX benchmark's ``synth_step`` and ``wave_step`` do; ``f32`` in float32.

    python -m quickvc_tpu_torch.scripts.realtime_bench [--device cuda|cpu] [--iters 20]
        [--precision bf16|f32] [--max-streams N]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from quickvc_tpu_torch import ops
from quickvc_tpu_torch.config import QuickVCConfig
from quickvc_tpu_torch.infer.realtime import RealtimeSession, RealtimeWaveSession
from quickvc_tpu_torch.models.hubert import HubertSoft
from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
from quickvc_tpu_torch.scripts import time_ms
from quickvc_tpu_torch.utils.device import resolve_device
from quickvc_tpu_torch.utils.weights import init_random_

FRAME_MS = 20.0  # hop 320 at 16 kHz
SEED = 0
# (domain, streams, chunk, left, right): chunk 16 = 320 ms ticks with 960 ms of
# past and 320 ms of lookahead context; then the low-latency point, 80 ms ticks
# with 80 ms of lookahead
POINTS = ([("units", n, 16, 48, 16) for n in (1, 8, 64, 256, 512)]
          + [("wave", n, 16, 48, 16) for n in (1, 8, 64, 256)]
          + [(domain, n, 4, 60, 4) for n in (1, 64) for domain in ("units", "wave")])


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--iters", type=int, default=20, help="timed steps per point")
    p.add_argument("--precision", choices=["f32", "bf16"], default="bf16")
    p.add_argument("--max-streams", type=int, default=None,
                   help="skip the points with more concurrent streams than this")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the benchmark; returns one record per point."""
    args = parse_args(argv)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    cfg = QuickVCConfig()
    hop = cfg.data.hop_length
    net = init_random_(SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model),
                       SEED).to(device).eval()
    hubert = init_random_(HubertSoft(), SEED + 1).to(device).eval()
    rng = np.random.default_rng(SEED)

    records = []
    for domain, n, chunk, left, right in POINTS:
        if args.max_streams is not None and n > args.max_streams:
            continue
        g = rng.standard_normal((n, cfg.model.gin_channels)).astype(np.float32)
        g /= np.linalg.norm(g, axis=1, keepdims=True)
        kw = dict(chunk=chunk, left=left, right=right, hop_length=hop, device=device,
                  dtype=dtype)
        window = left + chunk + right
        if domain == "units":
            session = RealtimeSession(net, g, **kw)
            win = rng.standard_normal((n, window, cfg.model.unit_channels))
        else:
            session = RealtimeWaveSession(net, g, hubert, **kw)
            win = 0.1 * rng.standard_normal((n, window * hop))
        win = torch.from_numpy(win.astype(np.float32)).to(device)
        session.step(win)   # cuDNN set-up for this shape
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ops.reset_launch_counts()
        session.step(win)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        step_ms = time_ms(lambda: session.step(win), device, args.iters)
        chunk_ms = chunk * FRAME_MS
        rec = {"domain": domain, "streams": n, "chunk_ms": chunk_ms,
               "lookahead_ms": right * FRAME_MS, "window_frames": window, "device": kind,
               "precision": args.precision,
               "step_ms": step_ms, "rtf": step_ms / chunk_ms,
               "latency_ms": chunk_ms + right * FRAME_MS + step_ms,
               "realtime": step_ms < chunk_ms, "launches_per_tick": launches}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
