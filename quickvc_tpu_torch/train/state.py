"""Train state: G and D, their AdamW optimizers and per-epoch LR schedules.

Port of ``quickvc_tpu/train/state.py:39-52`` (reference ``train.py:57-75``):
``AdamW(lr, betas, eps, weight_decay=0.01)`` for each network and
``ExponentialLR(gamma=lr_decay)`` stepped once per epoch. Options of the
JAX trainer that the port does not have yet raise at start.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from quickvc_tpu_torch.config import QuickVCConfig
from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
from quickvc_tpu_torch.utils.weights import init_random_


@dataclass
class TrainState:
    cfg: QuickVCConfig
    net_g: SynthesizerTrn
    net_d: MultiPeriodDiscriminator
    optim_g: torch.optim.AdamW
    optim_d: torch.optim.AdamW
    sched_g: torch.optim.lr_scheduler.ExponentialLR
    sched_d: torch.optim.lr_scheduler.ExponentialLR
    step: int = 0  # optimizer steps taken (skipped updates included)


def check_supported(cfg: QuickVCConfig) -> None:
    """Raise NotImplementedError for JAX-trainer options the port lacks."""
    t = cfg.train
    missing = [
        (t.split_prior, "train.split_prior=true", 12),
        (t.zero_opt_state, "train.zero_opt_state=true (ZeRO-1 moments)", 12),
        (t.grad_reduce_dtype != "f32",
         f"train.grad_reduce_dtype={t.grad_reduce_dtype!r}", 12),
        (t.num_hosts > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1,
         "more than one training process", 12),
    ]
    for bad, what, item in missing:
        if bad:
            raise NotImplementedError(
                f"{what}: not ported yet (ROADMAP queue A step {item}); the "
                "port trains in one process")


def make_optimizer(params, cfg: QuickVCConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=cfg.train.learning_rate,
                             betas=tuple(cfg.train.betas), eps=cfg.train.eps,
                             weight_decay=0.01)


def build_models(cfg: QuickVCConfig) -> tuple[SynthesizerTrn, MultiPeriodDiscriminator]:
    return (SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model),
            MultiPeriodDiscriminator(width=cfg.train.disc_width))


def create_train_state(cfg: QuickVCConfig, device: torch.device,
                       net_g: SynthesizerTrn | None = None,
                       net_d: MultiPeriodDiscriminator | None = None) -> TrainState:
    """Models (seeded random weights unless given), optimizers, schedules."""
    if net_g is None or net_d is None:
        net_g, net_d = build_models(cfg)
        init_random_(net_g, cfg.train.seed)
        init_random_(net_d, cfg.train.seed + 1)
    net_g, net_d = net_g.to(device).train(), net_d.to(device).train()
    optim_g = make_optimizer(net_g.parameters(), cfg)
    optim_d = make_optimizer(net_d.parameters(), cfg)
    gamma = cfg.train.lr_decay
    return TrainState(cfg, net_g, net_d, optim_g, optim_d,
                      torch.optim.lr_scheduler.ExponentialLR(optim_g, gamma),
                      torch.optim.lr_scheduler.ExponentialLR(optim_d, gamma))


def set_epoch(state: TrainState, epoch: int) -> None:
    """Put both schedules at ``epoch`` (1-based; after a resume): learning
    rate ``learning_rate * lr_decay**(epoch - 1)``."""
    lr = state.cfg.train.learning_rate * state.cfg.train.lr_decay ** (epoch - 1)
    for optim, sched in ((state.optim_g, state.sched_g), (state.optim_d, state.sched_d)):
        for group in optim.param_groups:
            group["lr"] = lr
        sched.last_epoch = epoch - 1
