"""The cross-rank reductions of the data-parallel training step.

Port of ``quickvc_tpu/parallel/shard_step.py``: JAX's explicit-collective
step (``jax.shard_map``) hands ``make_train_step`` two hooks, which the
port's :func:`quickvc_tpu_torch.train.step.train_step` calls at the same
points (``quickvc_tpu/train/step.py:244-256, 302-351``):

- gradients: :func:`grad_reduce` turns each rank's batch-mean gradients into
  their mean over the ranks, the global batch-mean gradient. With
  ``train.grad_reduce_dtype: "bf16"`` that mean is taken in bf16 and cast
  back, ``pmean(g.astype(bf16)).astype(g.dtype)``: only the cross-rank
  mean is rounded; the backward and AdamW stay float32. With
  ``train.zero_opt_state`` :func:`grad_reduce_scatter` leaves each rank only
  its ZeRO-1 shard of that mean. Each network's gradients cross as one flat
  buffer (one collective), not one call per tensor.
- loss scalars: :func:`scalar_reduce` averages them the same way before the
  non-finite guard, so the skip decision, ``grad_norm/*`` and every logged
  value are global and the same on every rank; the replicated parameters
  cannot drift apart.
- randomness: each rank seeds its generator from (seed, rank)
  (:func:`rank_seed`), as each JAX shard folds its index into the step's
  key: every row of the global batch sees its own draw. Rank 0 draws what
  the single-process trainer draws.

Semantics against one process on the global batch: the mel-L1, KL, LSGAN
and feature-matching terms are batch means, so with equal per-rank batches
the mean over ranks is the global one (to float32 summation order). The
sub-band STFT loss of ``model.mb_istft_vits`` is not: its spectral
convergence is a norm ratio over the whole batch
(``quickvc_tpu/losses.py:47-52``). At a float32 reduce the port computes
that ratio from sums over the ranks (:func:`sum_over_ranks`,
``losses.py:multi_resolution_stft_loss``), as JAX's float32 trainer does under
GSPMD over the global batch (``quickvc_tpu/train/loop.py:131-143``), with
its gradient scaled so that the reduce's mean is the global ratio's. At a
bf16 reduce each rank's ratio over its own rows is averaged, as in JAX's
explicit-collective step, which is rank-local (``shard_map``).

Under tensor parallelism (:mod:`quickvc_tpu_torch.parallel.tp`) every one of
these reductions runs over the data group alone (``group=``): the model
ranks of one data index hold the same rows and their replicated values are
already equal.

The bf16 mean's order: at two ranks ``round_bf16(a + b) / 2`` is the same
in XLA, gloo and NCCL; at more, NCCL's ring sums in its own order, so the
rounding may differ from XLA's in the last bit.

Without a process group, or over a group of one rank (the data group of a
tensor-parallel mesh with one data index), every reduction is the identity,
except that the bf16 reduce still rounds each gradient through bf16, as
the JAX trainer's bf16-reduce step does on one device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from quickvc_tpu_torch.parallel.mesh import Zero1Partition, gloo_staged, is_distributed

RANK_STRIDE = 1 << 40   # rank r's seeds sit r * 2^40 above rank 0's


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of ``rank`` for a step whose rank-0 seed is ``seed``."""
    return seed + rank * RANK_STRIDE


def group_size(group=None) -> int:
    """Ranks in ``group`` (the default group if None); 1 without a process group."""
    return dist.get_world_size(group) if is_distributed() else 1


def grad_reduce(grads: Sequence[torch.Tensor], dtype: torch.dtype = torch.float32,
                async_op: bool = False, group=None) -> Callable[[], list[torch.Tensor]]:
    """The mean over the ranks of ``group`` (every rank if None) of each
    rank's ``grads``, taken in ``dtype`` and cast back: returns a function
    that waits for it and returns the list. With ``async_op`` the all-reduce
    is in flight until that call."""
    world = group_size(group)
    if world == 1 and dtype == grads[0].dtype:
        return lambda: list(grads)
    # one cast of the flat buffer each way (a cast per tensor costs a launch each)
    flat = torch.cat([g.reshape(-1) for g in grads]).to(dtype)
    work, copy_back = None, lambda: flat
    if world > 1:
        staged, _, copy_back = gloo_staged(flat, group=group)
        work = dist.all_reduce(staged, group=group, async_op=async_op)

    def wait() -> list[torch.Tensor]:
        if work is not None:
            work.wait()
        mean = copy_back().div_(world).to(grads[0].dtype)
        return [v.view_as(g) for v, g in zip(mean.split([g.numel() for g in grads]), grads)]

    return wait


def grad_reduce_scatter(part: Zero1Partition, grads: Sequence[torch.Tensor],
                        async_op: bool = False) -> Callable[[], torch.Tensor]:
    """This rank's ZeRO-1 shard of the float32 mean over ranks of ``grads``
    (a reduce-scatter of the flat buffer): returns a function that waits
    for it and returns the shard."""
    flat = part.flatten(grads)
    if not is_distributed():
        return lambda: flat
    shard, (flat,), copy_back = gloo_staged(flat.new_empty(part.shard), flat)
    work = dist.reduce_scatter_tensor(shard, flat, async_op=async_op)

    def wait() -> torch.Tensor:
        if work is not None:
            work.wait()
        return copy_back().div_(part.world)

    return wait


def all_gather(part: Zero1Partition, shard: torch.Tensor) -> torch.Tensor:
    """Every rank's shard end to end (``world * shard`` elements)."""
    if not is_distributed():
        return shard
    out, (shard,), copy_back = gloo_staged(shard.new_empty(part.world * part.shard), shard)
    dist.all_gather_into_tensor(out, shard)
    return copy_back()


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of ``group`` of ``t``, in place."""
    staged, _, copy_back = gloo_staged(t, group=group)
    dist.all_reduce(staged, group=group)
    return copy_back()


def sum_over_ranks(t: torch.Tensor, group=None) -> tuple[torch.Tensor, int]:
    """(the sum over the ranks of ``group`` of ``t``, their number), ``t``
    untouched: the batch-wide losses' global sums (``losses.py``)."""
    world = group_size(group)
    return (t, 1) if world == 1 else (_all_reduce(t.clone(), group), world)


def shard_stats(part: Zero1Partition, shard: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, 2-norm) of every parameter's gradient from the ranks' ZeRO-1
    shards: each rank's per-parameter partial sums and sums of squares,
    summed over the ranks in one all-reduce. The guard reads the sums, as
    the replicated step reads each gradient's sum; ``grad_norm/*`` reads
    the norms."""
    # float64 partial sums: the norm then agrees with the replicated step's
    # float32 one to its last bits, whatever the shards' boundaries
    stats = shard.new_zeros(2, len(part.sizes), dtype=torch.float64)
    pieces = part.pieces
    if pieces:
        used = sum(b - a for _, a, b in pieces)
        lengths = torch.tensor([b - a for _, a, b in pieces], device=shard.device)
        index = torch.tensor([i for i, _, _ in pieces], device=shard.device)
        x = shard[:used].double()
        stats[0, index] = torch.segment_reduce(x, "sum", lengths=lengths)
        stats[1, index] = torch.segment_reduce(x * x, "sum", lengths=lengths)
    if is_distributed():
        _all_reduce(stats)
    return stats[0].float(), stats[1].sqrt().float()


def scalar_reduce(tensors: Sequence[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The float32 mean over the ranks of ``group`` of each tensor (loss
    scalars, the loss vectors and the logged mel images), in one all-reduce."""
    world = group_size(group)
    if world == 1:
        return list(tensors)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    _all_reduce(flat, group).div_(world)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off : off + t.numel()].view_as(t))
        off += t.numel()
    return out
