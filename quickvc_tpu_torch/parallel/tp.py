"""Tensor parallelism: the wide parameters split over a (data, model) process mesh.

Port of ``quickvc_tpu/parallel/tp.py``. JAX builds a 2-D device mesh and
annotates each parameter leaf with a ``PartitionSpec``: ``_kernel_spec``
shards a leaf's last axis on ``model`` when that axis holds at least
``min_channels`` (256) and divides by the model size, and replicates the
rest; the AdamW moments take their parameter's layout, batches split over
``data`` only, and GSPMD inserts the collectives. The port runs one process
a rank:

- :func:`mesh_2d` makes the two process groups of a (data, model) mesh, rank
  ``r = d * model + m`` as JAX reshapes its devices (``tp.py:29-31``): the
  model group of the ranks of data index ``d`` and the data group of the
  ranks of model index ``m``.
- :func:`shard_dim` is ``_kernel_spec`` on the port's layout: the torch dim
  that JAX's last axis maps to under ``utils/weights.py``'s mapping. That is
  dim 0 for every conv, ``ConvTranspose1d``, ``Linear``, ``weight_g`` and
  bias (for ``ConvTranspose1d`` dim 0 of ``weight_v`` ``(in, out, k)`` is
  its input channels: JAX stores it ``(k, out, in)``) and dim 1 for the
  speaker LSTM's ``weight_ih_l*`` / ``weight_hh_l*`` ``(4H, in)``, which JAX
  keeps in torch's layout. The threshold reads JAX's axis: the last
  res/skip layer of a WaveNet is ``h`` wide in the port and ``2h`` in JAX
  (the unused res half, ``utils/weights.py:_wavenet``), so its width is
  ``2h``.
- :func:`param_layout` gives that dim (or None) for every parameter of a
  network; :func:`state_layout` the same for each AdamW moment, the step
  counts replicated (``tp.py:60-72``). ``train/state.py:create_train_state
  (tp=...)`` shards the networks by it (``parallel/tp_layers.py``), so AdamW
  holds its moments in the same layout.
- The batch splits over ``data`` only (``tp.py:75``): :func:`batch_rows`,
  :func:`bucket_sampler`; each data rank seeds its draws from its data index
  (:func:`step_seed`), so the model ranks of one data index draw the same.
- :func:`gather_state_dict` and :func:`gather_optimizer_state_dict` give a
  sharded network's reference-layout state dict and plain AdamW state
  (collectives of the model group: every model rank calls them).

As in JAX nothing wires this into the trainer CLI: it is reached through
this module and ``create_train_state``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from quickvc_tpu_torch.data.dataset import BUCKET_BOUNDARIES, BucketSampler
from quickvc_tpu_torch.models.modules import WN
from quickvc_tpu_torch.parallel.shard_step import rank_seed
from quickvc_tpu_torch.parallel.tp_layers import ModelAxis, all_gather

_LSTM_WEIGHT = re.compile(r"(^|\.)weight_(ih|hh)_l\d+$")


@dataclass(frozen=True)
class Mesh2D:
    """A (data, model) mesh of processes as this rank sees it."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model_group, self.model, self.model_rank)


def mesh_2d(data: int, model: int) -> Mesh2D:
    """The (data, model) mesh over the ``data * model`` ranks of the default
    process group (NCCL on the cards, gloo on the CPU): every rank makes
    every group, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, not {world}")
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    d, m = divmod(rank, model)
    return Mesh2D(data, model, d, m, data_groups[m], model_groups[d])


def shard_dim(name: str, tensor: torch.Tensor, model: int, min_channels: int = 256,
              jax_width: int | None = None) -> int | None:
    """``_kernel_spec`` (``quickvc_tpu/parallel/tp.py:36-46``) on the port's
    layout: the dim of ``tensor`` (parameter ``name``) split on the model
    axis, or None. ``jax_width`` is JAX's last-axis size where it differs
    from the torch dim's (a WaveNet's last res/skip layer)."""
    if tensor.dim() == 0:
        return None
    dim = 1 if _LSTM_WEIGHT.search(name) else 0
    width = tensor.shape[dim] if jax_width is None else jax_width
    if width >= min_channels and width % model == 0 and tensor.shape[dim] % model == 0:
        return dim
    return None


def _jax_widths(net: nn.Module) -> dict[str, int]:
    """Parameters whose JAX leaf is wider on its last axis than the torch
    dim: each WaveNet's last res/skip layer, ``2h`` in JAX."""
    out = {}
    for prefix, module in net.named_modules():
        if isinstance(module, WN):
            last = f"{prefix}.res_skip_layers.{module.n_layers - 1}"
            for n in ("weight_v", "weight_g", "bias"):
                out[f"{last}.{n}"] = 2 * module.hidden_channels
    return out


def param_layout(net: nn.Module, model: int, min_channels: int = 256) -> dict[str, int | None]:
    """The split dim (or None) of every parameter of ``net``, by name."""
    widths = _jax_widths(net)
    return {n: shard_dim(n, p, model, min_channels, widths.get(n))
            for n, p in net.named_parameters()}


def state_layout(net: nn.Module, optim: torch.optim.Optimizer,
                 layout: dict[str, int | None]) -> dict[str, dict[str, int | None]]:
    """For each parameter's AdamW state (by parameter name): each moment
    split as its parameter, the step count (a scalar) replicated."""
    names = {id(p): n for n, p in net.named_parameters()}
    return {names[id(p)]: {k: (layout[names[id(p)]] if v.dim() else None)
                           for k, v in st.items()}
            for p, st in optim.state.items()}


def batch_rows(mesh: Mesh2D, rows: int) -> slice:
    """This rank's rows of a global batch of ``rows``: its data index's
    share; every model rank of that index takes the same."""
    n = rows // mesh.data
    return slice(mesh.data_rank * n, (mesh.data_rank + 1) * n)


def bucket_sampler(lengths: Sequence[int], batch_size: int, mesh: Mesh2D,
                   boundaries: Sequence[int] = BUCKET_BOUNDARIES) -> BucketSampler:
    """The length-bucketed sampler of this rank's data index: the data ranks
    split each global batch, the model ranks of one index see the same."""
    return BucketSampler(lengths, batch_size, boundaries, num_replicas=mesh.data,
                         rank=mesh.data_rank)


def step_seed(seed: int, mesh: Mesh2D) -> int:
    """The generator seed of this rank's step draws (posterior noise, slice
    starts): its data index's, so the model ranks of one index agree."""
    return rank_seed(seed, mesh.data_rank)


def _whole(t: torch.Tensor, dim: int | None, axis: ModelAxis) -> torch.Tensor:
    """A copy of ``t`` whole: all-gathered if split on ``dim``."""
    return t.detach().clone() if dim is None else all_gather(t.detach(), dim, axis)


@torch.no_grad()
def gather_state_dict(net: nn.Module) -> dict[str, torch.Tensor]:
    """The reference-layout state dict of a network that
    ``tp_layers.shard_modules_`` sharded: every split parameter
    all-gathered, the buffers as they are."""
    layout, axis = net.tp_layout, net.tp_axis
    return {k: _whole(v, layout.get(k), axis) for k, v in net.state_dict().items()}


@torch.no_grad()
def gather_optimizer_state_dict(net: nn.Module, optim: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict in plain AdamW's layout over the whole
    network: each split moment all-gathered."""
    layout = state_layout(net, optim, net.tp_layout)
    names = [n for n, _ in net.named_parameters()]
    sd = optim.state_dict()
    state = {i: {k: _whole(v, layout[names[i]][k], net.tp_axis) for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def local_bytes(net: nn.Module, optim: torch.optim.Optimizer | None = None) -> dict[str, int]:
    """Bytes this rank holds of the network's parameters and of its moments."""
    out = {"params": sum(p.numel() * p.element_size() for p in net.parameters())}
    if optim is not None:
        out["moments"] = sum(v.numel() * v.element_size() for st in optim.state.values()
                             for v in st.values() if v.dim())
    return out
