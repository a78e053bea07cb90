"""The model-axis collectives of tensor parallelism, and the sharded layers.

Every model rank of one data index runs the whole network on the same rows,
so every activation is replicated (bit-equal on the model ranks); only the
wide parameters are split (:func:`quickvc_tpu_torch.parallel.tp.param_layout`
says which and on what dim). A sharded layer computes its part from the
replicated input and hands a replicated output on, through Megatron's pair
of ``torch.autograd.Function`` s:

- :class:`Copy`: identity forward, all-reduce backward, on the replicated
  input of a layer that uses it on one rank's part only (each rank's input
  gradient is its part's; their sum is the whole);
- :class:`Gather`: all-gather forward (the ranks' slices end to end), slice
  backward, on the output of a layer that computed one rank's channels.

and two more for a layer split on its input channels: :class:`Scatter`
(this rank's slice forward, all-gather backward) and :class:`ReduceSum`
(all-reduce forward, identity backward). So a sharded leaf's gradient is
local, and a replicated leaf's is the same on every model rank.

:func:`shard_modules_` swaps each sharded module's parameters for this
rank's slice (same names) and its class for the tensor-parallel subclass
(``TP_CLASSES``):

- ``Conv1d``, ``WNConv1d``, ``WNConv2d``, ``Linear`` split on their output
  channels (dim 0 of weight, ``weight_g`` and bias): column-parallel, this
  rank's output channels, all-gathered. Weight norm's dim is dim 0, so it
  stays local. A grouped conv takes only its groups' input channels: with
  ``groups`` a multiple of the model size each rank has whole groups (its
  slice of the input, ``groups / model`` of them); with the model size a
  multiple of ``groups`` each rank has part of one group (that group's
  input, one group).
- ``WNConvTranspose1d`` split on its input channels (JAX stores its kernel
  ``(k, out, in)`` and shards the last axis): row-parallel, this rank's input
  channels through its slice of the weight, the partial outputs summed by
  an all-reduce, then the bias, whole (all-gathered where it is split on its
  output channels). Its weight norm is over (out, k), one gain per input
  channel: local too.
- ``nn.LSTM`` (the speaker encoder's; JAX keeps torch's layout, so its
  weights split on dim 1 and its biases on dim 0): a split weight read by
  name comes back gathered (slice backward), once a forward, and the
  recurrence runs whole: splitting its 512 serial steps would cost a
  collective a step.

On the card the collectives are NCCL's, or gloo's through host copies
(``mesh.gloo_staged``). A bf16 partial sum is summed in float32 and rounded
once. :data:`STATS` counts each kind's calls and bytes.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.models.layers import (Conv1d, Linear, WNConv1d, WNConv2d,
                                             WNConvTranspose1d, conv)
from quickvc_tpu_torch.parallel.mesh import gloo_staged

# kind -> {"calls", "bytes" (this rank's share it sends or receives), "seconds" (host)}
STATS: dict[str, dict[str, float]] = defaultdict(lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})


def reset_stats() -> None:
    STATS.clear()


@dataclass(frozen=True)
class ModelAxis:
    """The model group and this rank's place in it."""

    group: Any
    size: int
    rank: int


def _count(kind: str, nbytes: int, t0: float) -> None:
    s = STATS[kind]
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += time.perf_counter() - t0


def all_gather(x: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """Every model rank's ``x`` end to end along ``dim``, in rank order."""
    if axis.size == 1:
        return x
    t0 = time.perf_counter()
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((axis.size * xt.shape[0],) + tuple(xt.shape[1:]))
    staged, (part,), copy_back = gloo_staged(out, xt, group=axis.group)
    dist.all_gather_into_tensor(staged, part, group=axis.group)
    out = copy_back().movedim(0, dim).contiguous()   # a layer's output layout
    _count("all_gather", out.numel() * out.element_size(), t0)
    return out


def all_reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum over the model ranks of ``x``, in float32 for a narrower
    float (each rank's value rounded once already, the sum once more), in a
    new tensor."""
    dtype = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    out = x.to(dtype, copy=True)
    if axis.size == 1:
        return out
    t0 = time.perf_counter()
    staged, _, copy_back = gloo_staged(out, group=axis.group)
    dist.all_reduce(staged, group=axis.group)
    out = copy_back()
    _count("all_reduce", out.numel() * out.element_size(), t0)
    return out


def _own(x: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    return x.chunk(axis.size, dim)[axis.rank].contiguous()


class Copy(torch.autograd.Function):
    """Identity forward; backward, the sum over the model ranks of the gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis).to(g.dtype), None


class Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward, this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.axis), None, None


class Scatter(torch.autograd.Function):
    """This rank's slice along ``dim`` forward; backward, the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _own(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


class ReduceSum(torch.autograd.Function):
    """The sum over the model ranks forward (float32 for a narrower float);
    backward, the gradient as it is, in the input's dtype."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.dtype = x.dtype
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


# --------------------------------------------------------------------------
# the sharded layers: each a subclass of its layer, which shard_modules_
# gives the module in place of its class


class _ColumnParallel:
    """Mixed into a layer split on its output channels: this rank's output
    channels from the replicated input (its groups' channels of it), all-
    gathered. ``tp_input``: None (the whole input), "scatter" (this rank's
    slice) or (first, end); ``tp_groups``: this rank's groups of a grouped
    conv, else None."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis, plan = self.tp_axis, self.tp_input
        if plan == "scatter":
            x = Scatter.apply(x, 1, axis)
        else:
            x = Copy.apply(x, axis)
            if plan is not None:
                x = x[:, plan[0] : plan[1]]
        if self.tp_groups is None:
            y = super().forward(x)
        else:
            w = self.weight() if isinstance(self, WNConv1d) else self.weight
            y = conv(F.conv1d, x, w, self.bias, self.stride, self.padding, self.dilation,
                     self.tp_groups)
        return Gather.apply(y, -1 if isinstance(self, nn.Linear) else 1, axis)


class _RowParallel:
    """Mixed into a ``WNConvTranspose1d``: the transposed conv on this rank's
    input channels, summed over the ranks, then the whole bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.tp_axis
        bias = self.bias
        if self.tp_bias_sharded:
            bias = Gather.apply(bias, 0, axis)
        if not self.tp_weight_sharded:
            return conv(F.conv_transpose1d, x, self.weight(), bias, self.stride, self.padding,
                        self.output_padding)
        part = conv(F.conv_transpose1d, Scatter.apply(x, 1, axis), self.weight(), None,
                    self.stride, self.padding, self.output_padding)
        y = ReduceSum.apply(part, axis)
        return (y + bias.to(y.dtype)[:, None]).to(x.dtype)


class _GatheredLSTM:
    """Mixed into an ``nn.LSTM`` whose parameters named in ``tp_dims`` (name ->
    dim) are this rank's slices: reading one by name returns it gathered
    whole (slice backward), so both recurrences, ``forward``'s and the
    speaker encoder's bf16 stack (``models/encoders.py``), run on the whole
    weights. On the card cuDNN copies the gathered weights into one buffer
    a call, as it does any weights not flattened in place."""

    def __getattr__(self, name: str):
        dims = self.__dict__.get("tp_dims", {})
        if name in dims:
            return Gather.apply(self._parameters[name], dims[name], self.tp_axis)
        return super().__getattr__(name)

    def _init_flat_weights(self) -> None:
        # the slices, not gathered on every .to(): forward gathers them
        self._flat_weights = [self._parameters[n] for n in self._flat_weights_names]
        self._flat_weight_refs = [weakref.ref(w) for w in self._flat_weights]

    def forward(self, x: torch.Tensor, hx=None):
        """``nn.LSTM.forward`` (batch first, no dropout, one direction) on
        the gathered weights."""
        if hx is None:
            zeros = x.new_zeros(self.num_layers, x.shape[0], self.hidden_size)
            hx = (zeros, zeros)
        out, h, c = torch.lstm(x, hx, [getattr(self, n) for n in self._flat_weights_names],
                               self.bias, self.num_layers, self.dropout, self.training,
                               self.bidirectional, self.batch_first)
        return out, (h, c)


class ColumnConv1d(_ColumnParallel, Conv1d):
    pass


class ColumnWNConv1d(_ColumnParallel, WNConv1d):
    pass


class ColumnWNConv2d(_ColumnParallel, WNConv2d):
    pass


class ColumnLinear(_ColumnParallel, Linear):
    pass


class RowWNConvTranspose1d(_RowParallel, WNConvTranspose1d):
    pass


class GatheredLSTM(_GatheredLSTM, nn.LSTM):
    pass


# a layer's class -> its tensor-parallel subclass
TP_CLASSES = {Conv1d: ColumnConv1d, WNConv1d: ColumnWNConv1d, WNConv2d: ColumnWNConv2d,
              Linear: ColumnLinear, WNConvTranspose1d: RowWNConvTranspose1d,
              nn.LSTM: GatheredLSTM}


def _group_plan(module, axis: ModelAxis):
    """(the input plan of a column-parallel conv, its groups on this rank):
    (None, None) ungrouped; ("scatter", groups / model): this rank's slice
    of the input, whole groups; ((first, end), 1): the input of the one group
    this rank's channels lie in."""
    groups = getattr(module, "groups", 1)
    if groups == 1:
        return None, None
    if groups % axis.size == 0:
        return "scatter", groups // axis.size
    if axis.size % groups:
        raise ValueError(f"{groups} groups split over {axis.size} model ranks: neither "
                         "divides the other")
    in_per_group = module.weight_v.shape[1] if hasattr(module, "weight_v") else (
        module.weight.shape[1])
    g = axis.rank // (axis.size // groups)
    return (g * in_per_group, (g + 1) * in_per_group), 1


def shard_modules_(net: nn.Module, layout: dict[str, int | None], axis: ModelAxis) -> nn.Module:
    """Give each module of ``net`` with a split parameter (``layout``: name ->
    dim or None, :func:`quickvc_tpu_torch.parallel.tp.param_layout`) this
    rank's slice of it, same name, and its tensor-parallel class
    (``TP_CLASSES``); records ``net.tp_layout`` and ``net.tp_axis``. Raises
    ValueError for a module with no tensor-parallel form."""
    for prefix, module in net.named_modules():
        if getattr(module, "fused_conv5", False) and any(
                d is not None for n, d in layout.items() if n.startswith(f"{prefix}.")):
            raise ValueError(f"{prefix}: the fused K5/K6 discriminator has no "
                             "tensor-parallel form")
        own = {n: layout.get(f"{prefix}.{n}" if prefix else n)
               for n, _ in module.named_parameters(recurse=False)}
        split = {n: d for n, d in own.items() if d is not None}
        if not split:
            continue
        tp_class = TP_CLASSES.get(type(module))
        if tp_class is None:
            raise ValueError(f"{prefix}: {type(module).__name__} has no tensor-parallel form")
        if isinstance(module, WNConvTranspose1d):
            if "weight_v" in split and (split.get("weight_g") != 0 or module.norm_dim != 0):
                raise ValueError(f"{prefix}: weight norm must split with its weight")
            module.tp_weight_sharded, module.tp_bias_sharded = "weight_v" in split, "bias" in split
        elif not isinstance(module, nn.LSTM):
            if set(split.values()) != {0} or set(split) != set(own):
                raise ValueError(f"{prefix}: column-parallel needs every parameter split "
                                 f"on its output channels, got {split} of {list(own)}")
            if getattr(module, "norm_dim", 0) != 0:
                raise ValueError(f"{prefix}: weight norm over another dim than the split")
            module.tp_input, module.tp_groups = _group_plan(module, axis)
        for n, d in split.items():
            p = getattr(module, n)
            setattr(module, n, nn.Parameter(_own(p.detach(), d, axis),
                                            requires_grad=p.requires_grad))
        module.tp_axis, module.tp_dims = axis, split
        module.__class__ = tp_class
    net.tp_layout, net.tp_axis = dict(layout), axis
    return net
