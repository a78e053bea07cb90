"""Training loop and CLI of the PyTorch/CUDA port.

    python -m quickvc_tpu_torch.train -c configs/quickvc.json -m NAME -mr ./logs
        [--max-steps N] [--device cuda|cpu]

Port of the core of ``quickvc_tpu/train/loop.py`` (reference ``train.py``):
epochs over the length-bucketed loader, one :func:`train_step` per batch,
the learning rate decayed once per epoch, losses logged every
``log_interval`` steps to stdout and ``model_dir/train.log``, and
reference-format ``G_{step}.pth``/``D_{step}.pth`` written every
``eval_interval`` steps and at the end. A run resumes from the newest pair
in ``model_dir``, mid-epoch included (the loader skips the batches already
trained on). Eval, TensorBoard, telemetry, the supervisor's exit-75 restart
contract and process-mode loaders are not ported yet.

Runs on the card unless ``--device cpu`` is given; CUDA without a card raises.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from quickvc_tpu_torch.config import QuickVCConfig, get_config
from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                            UnitAudioSpecDataset)
from quickvc_tpu_torch.train.state import check_supported, create_train_state, set_epoch
from quickvc_tpu_torch.train.step import mel_basis, train_step
from quickvc_tpu_torch.utils.checkpoint import latest_step, load_checkpoint, save_checkpoint
from quickvc_tpu_torch.utils.device import resolve_device


def _logger(model_dir: str) -> logging.Logger:
    log = logging.getLogger("quickvc_tpu_torch.train")
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    log.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.StreamHandler(sys.stdout),
              logging.FileHandler(os.path.join(model_dir, "train.log"))):
        h.setFormatter(fmt)
        log.addHandler(h)
    log.propagate = False
    return log


def _save(state, lr: float, epoch: int) -> tuple[str, str]:
    paths = tuple(os.path.join(state.cfg.model_dir, f"{k}_{state.step}.pth") for k in "GD")
    save_checkpoint(paths[0], state.net_g, state.optim_g, lr, epoch)
    save_checkpoint(paths[1], state.net_d, state.optim_d, lr, epoch)
    return paths


def run(cfg: QuickVCConfig, device: torch.device, max_steps: int | None = None) -> dict:
    """Train; returns {"steps", "losses" (one dict per step), "step_seconds",
    "checkpoint" (the last G/D paths written)}."""
    check_supported(cfg)
    log = _logger(cfg.model_dir)
    train_ds = UnitAudioSpecDataset("train", cfg, with_spec=cfg.train.transfer != "compact")
    sampler = BucketSampler(train_ds.lengths, cfg.train.batch_size, BUCKET_BOUNDARIES)
    loader = DataLoader(train_ds, sampler, cfg, num_workers=cfg.train.loader_workers,
                        seed=cfg.train.seed, prefetch=cfg.train.prefetch_batches)
    if len(loader) == 0:
        raise ValueError(f"no utterance of {cfg.data.training_files} falls in a "
                         f"length bucket ({BUCKET_BOUNDARIES[0]}-"
                         f"{BUCKET_BOUNDARIES[-1]} frames)")
    state = create_train_state(cfg, device)
    log.info("Generator params: %.2fM | Discriminator params: %.2fM on %s",
             sum(p.numel() for p in state.net_g.parameters()) / 1e6,
             sum(p.numel() for p in state.net_d.parameters()) / 1e6, device)
    resumed = latest_step(cfg.model_dir)
    if resumed is not None:
        for kind, net, optim in (("G", state.net_g, state.optim_g),
                                 ("D", state.net_d, state.optim_d)):
            load_checkpoint(os.path.join(cfg.model_dir, f"{kind}_{resumed}.pth"), net, optim)
        state.step = resumed
        log.info("Resumed from checkpoint at step %d", resumed)

    basis = mel_basis(cfg, device)
    gen = torch.Generator(device=device)
    epoch0 = state.step // len(loader) + 1
    set_epoch(state, epoch0)
    loader.skip_next_iter(state.step % len(loader))
    out = {"steps": state.step, "losses": [], "step_seconds": [], "checkpoint": None}
    unhealthy = 0
    for epoch in range(epoch0, cfg.train.epochs + 1):
        sampler.set_epoch(epoch)
        lr = state.optim_g.param_groups[0]["lr"]
        for host_batch in loader:
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in host_batch.items()}
            gen.manual_seed(cfg.train.seed * 1_000_003 + state.step)  # resumable draws
            m = train_step(state, batch, basis, generator=gen)
            scalars = {k: float(m[f"loss/{k}"]) for k in ("g/total", "d/total", "g/mel", "g/kl")}
            skipped = float(m.get("guard/d_skipped", 0.0)) + float(m.get("guard/g_skipped", 0.0))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["step_seconds"].append(time.perf_counter() - t0)
            out["losses"].append(dict(scalars, step=state.step, skipped=skipped))
            out["steps"] = state.step
            if not all(math.isfinite(v) for v in scalars.values()) or skipped:
                unhealthy += 1
                guarded = cfg.train.guard_nonfinite or cfg.train.guard_loss_max > 0
                if not guarded or unhealthy >= 10:
                    raise FloatingPointError(
                        f"unhealthy training at step {state.step}: {scalars}, "
                        f"{skipped:g} updates skipped; a restart resumes from "
                        "the last checkpoint")
                log.warning("unhealthy step %d (%s); the guard left the params "
                            "untouched", state.step, scalars)
            else:
                unhealthy = 0
            if (state.step - 1) % cfg.train.log_interval == 0:
                log.info("epoch %d step %d lr %.3e | g %.3f d %.3f mel %.3f kl %.3f "
                         "(%.3f s)", epoch, state.step, lr, scalars["g/total"],
                         scalars["d/total"], scalars["g/mel"], scalars["g/kl"],
                         out["step_seconds"][-1])
            done = max_steps is not None and state.step >= max_steps
            if done or (cfg.train.eval_interval and state.step % cfg.train.eval_interval == 0):
                out["checkpoint"] = _save(state, lr, epoch)
                log.info("saved %s", " and ".join(out["checkpoint"]))
            if done:
                return out
        state.sched_g.step()
        state.sched_d.step()
        log.info("====> Epoch %d done", epoch)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train QuickVC (PyTorch/CUDA port).")
    p.add_argument("-c", "--config", type=str, default="./configs/quickvc.json")
    p.add_argument("-m", "--model", type=str, default="quickvc")
    p.add_argument("-mr", "--modelroot", type=str, default="./logs")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop (and checkpoint) after N steps in all")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 everywhere: cuDNN convolutions would otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.config, args.model, args.modelroot)
    return run(cfg, device, args.max_steps)
