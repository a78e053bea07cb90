"""Train state: G and D, their AdamW optimizers and per-epoch LR schedules.

Port of ``quickvc_tpu/train/state.py:39-52`` (reference ``train.py:57-75``):
``AdamW(lr, betas, eps, weight_decay=0.01)`` for each network and
``ExponentialLR(gamma=lr_decay)`` stepped once per epoch.

With ``train.zero_opt_state`` (ZeRO-1, ``quickvc_tpu/parallel/mesh.py:
zero1_state_sharding``) each network's AdamW holds one flat parameter, this
rank's shard of the network's flattened parameters
(:class:`quickvc_tpu_torch.parallel.mesh.Zero1Partition`), so it keeps about
1/n of the replicated optimizer's moments. :func:`optimizer_state_dict` and
:func:`load_optimizer_state_dict` convert between that and plain AdamW's
layout (one entry per parameter), the layout checkpoints keep.

With ``tp=(mesh, min_channels)`` (tensor parallelism, port of
``quickvc_tpu/parallel/tp.py``'s ``state_shardings``) each network's wide
parameters are split over the mesh's model axis
(:func:`quickvc_tpu_torch.parallel.tp.param_layout`,
``parallel/tp_layers.py:shard_modules_``) before the optimizers are made, so
AdamW holds its moments in the same layout. The JAX package never runs
ZeRO-1 moments or the bf16 ``shard_map`` reduce under it; the port refuses
both there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from quickvc_tpu_torch.config import QuickVCConfig
from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
from quickvc_tpu_torch.parallel.mesh import Zero1Partition, zero1_partition
from quickvc_tpu_torch.parallel.shard_step import all_gather
from quickvc_tpu_torch.parallel.tp import Mesh2D, gather_optimizer_state_dict, param_layout
from quickvc_tpu_torch.parallel.tp_layers import shard_modules_
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
    zero_g: Zero1Partition | None = None   # ZeRO-1: this rank's part of G's moments
    zero_d: Zero1Partition | None = None
    mesh: Mesh2D | None = None             # tensor parallelism: the (data, model) mesh

    def nets(self, kind: str):
        """(network, optimizer, ZeRO-1 partition or None) of "g" or "d"."""
        if kind == "g":
            return self.net_g, self.optim_g, self.zero_g
        return self.net_d, self.optim_d, self.zero_d


def make_optimizer(params, cfg: QuickVCConfig) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=cfg.train.learning_rate,
                             betas=tuple(cfg.train.betas), eps=cfg.train.eps,
                             weight_decay=0.01)


def build_models(cfg: QuickVCConfig) -> tuple[SynthesizerTrn, MultiPeriodDiscriminator]:
    return (SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model),
            MultiPeriodDiscriminator(width=cfg.train.disc_width))


def check_tp(cfg: QuickVCConfig) -> None:
    """Raise ValueError for what tensor parallelism does not run with."""
    if cfg.train.zero_opt_state:
        raise ValueError("train.zero_opt_state under tensor parallelism: the JAX package "
                         "never shards the moments over data and model at once "
                         "(zero1_state_sharding is for its data-parallel mesh)")
    if cfg.train.grad_reduce_dtype != "f32":
        raise ValueError("train.grad_reduce_dtype 'bf16' under tensor parallelism: JAX's "
                         "bf16 reduce is its shard_map step over a data-parallel mesh, "
                         "which it never runs with a model axis")


def create_train_state(cfg: QuickVCConfig, device: torch.device,
                       net_g: SynthesizerTrn | None = None,
                       net_d: MultiPeriodDiscriminator | None = None,
                       tp: tuple[Mesh2D, int] | None = None) -> TrainState:
    """Models (seeded random weights unless given), optimizers, schedules;
    under ``train.zero_opt_state`` each optimizer over this rank's shard;
    with ``tp=(mesh, min_channels)`` the networks split over the mesh's
    model axis (the given networks are sharded in place)."""
    if tp is not None:
        check_tp(cfg)
    if net_g is None or net_d is None:
        net_g, net_d = build_models(cfg)
        init_random_(net_g, cfg.train.seed)
        init_random_(net_d, cfg.train.seed + 1)
    net_g, net_d = net_g.to(device).train(), net_d.to(device).train()
    mesh = None
    if tp is not None:
        mesh, min_channels = tp
        for net in (net_g, net_d):
            shard_modules_(net, param_layout(net, mesh.model, min_channels), mesh.model_axis)
    parts, optims = [], []
    for net in (net_g, net_d):
        params = list(net.parameters())
        part = zero1_partition(params) if cfg.train.zero_opt_state else None
        parts.append(part)
        optims.append(make_optimizer(
            params if part is None else [torch.nn.Parameter(part.take(params).detach())], cfg))
    gamma = cfg.train.lr_decay
    return TrainState(cfg, net_g, net_d, *optims,
                      torch.optim.lr_scheduler.ExponentialLR(optims[0], gamma),
                      torch.optim.lr_scheduler.ExponentialLR(optims[1], gamma),
                      zero_g=parts[0], zero_d=parts[1], mesh=mesh)


def optimizer_state_dict(state: TrainState, kind: str) -> dict:
    """The optimizer's ``state_dict`` in plain AdamW's layout, one entry per
    parameter of the network ("g" or "d"). Under ZeRO-1 every rank's moments
    are gathered first, under tensor parallelism every model rank's: a
    collective, so every rank calls it."""
    net, optim, part = state.nets(kind)
    if state.mesh is not None:
        return gather_optimizer_state_dict(net, optim)
    sd = optim.state_dict()
    if part is None:
        return sd
    params = list(net.parameters())
    group = dict(sd["param_groups"][0], params=list(range(len(params))))
    shard = sd["state"].get(0)
    if shard is None:   # no update taken yet
        return {"state": {}, "param_groups": [group]}
    full = {k: part.split(all_gather(part, v), params) for k, v in shard.items() if k != "step"}
    return {"state": {i: {k: v.clone() if k == "step" else full[k][i].clone()
                          for k, v in shard.items()} for i in range(len(params))},
            "param_groups": [group]}


def load_optimizer_state_dict(state: TrainState, kind: str, sd: dict) -> None:
    """Load a plain-layout optimizer ``state_dict`` (a checkpoint's); under
    ZeRO-1 this rank keeps its shard of the moments, under tensor
    parallelism its model rank's slice of each split one."""
    net, optim, part = state.nets(kind)
    if state.mesh is not None:   # this model rank's slice of each split moment
        dims = [net.tp_layout[n] for n, _ in net.named_parameters()]
        axis = state.mesh.model_axis
        sd = dict(sd, state={i: {k: v if dims[i] is None or not v.dim() else
                                 v.chunk(axis.size, dims[i])[axis.rank].clone()
                                 for k, v in st.items()} for i, st in sd["state"].items()})
    if part is None:
        optim.load_state_dict(sd)
        return
    st, n = sd["state"], len(part.sizes)
    shard = {0: {k: v if k == "step" else part.take([st[i][k] for i in range(n)])
                 for k, v in st[0].items()}} if st else {}
    optim.load_state_dict({"state": shard,
                           "param_groups": [dict(sd["param_groups"][0], params=[0])]})


def set_epoch(state: TrainState, epoch: int) -> None:
    """Put both schedules at ``epoch`` (1-based; after a resume): learning
    rate ``learning_rate * lr_decay**(epoch - 1)``."""
    lr = state.cfg.train.learning_rate * state.cfg.train.lr_decay ** (epoch - 1)
    for optim, sched in ((state.optim_g, state.sched_g), (state.optim_d, state.sched_d)):
        for group in optim.param_groups:
            group["lr"] = lr
        sched.last_epoch = epoch - 1
