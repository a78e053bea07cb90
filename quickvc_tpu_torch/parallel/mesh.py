"""The process group of the data-parallel trainer and the ZeRO-1 partition.

Port of ``quickvc_tpu/parallel/mesh.py`` and ``train.py:48-50``. JAX lays one
mesh axis ``data`` over every device of every host; the port runs one
process per card, started by a launcher:

    torchrun --nproc-per-node N -m quickvc_tpu_torch.train --distributed ...

``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``; :func:`init_process_group` joins that group (NCCL for
CUDA, gloo for the CPU) and makes ``cuda:LOCAL_RANK`` the process's current
device. Parameters stay replicated: every rank starts from rank 0's
(:func:`broadcast_from_rank0`). With ``train.zero_opt_state`` each rank
holds one contiguous shard of a network's flattened AdamW moments
(:class:`Zero1Partition`), the port's counterpart of
``zero1_state_sharding``: AdamW is elementwise, so updating each shard
apart and gathering the parameters takes the replicated update's values.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist


def launcher_world_size() -> int:
    """The number of processes the launcher started (``WORLD_SIZE``, else 1)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def init_process_group(device_type: str, init_method: str = "env://") -> tuple[torch.device, bool]:
    """Join the launcher's process group; returns (this rank's device, whether
    this call created the group). A group that already exists is kept (a
    caller that set one up itself, as the tests do with a ``file://``
    rendezvous)."""
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        # the kernels launch on the current device (csrc asks cudaGetDevice)
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device(device_type)
    if is_distributed():
        return device, False
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method)
    return device, True


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def gloo_staged(out: torch.Tensor, *inputs: torch.Tensor, group=None):
    """(out, inputs, copy_back) to hand a collective of ``group`` (the
    default group if None) that writes ``out`` and reads ``inputs``. Gloo
    moves host memory, so on a gloo group CUDA tensors are swapped for host
    copies (``out``'s keeps its values, for the in-place collectives) and
    ``copy_back()``, called once the collective has finished, writes the
    result into ``out`` and returns it; elsewhere the tensors pass as they
    are."""
    if not (out.is_cuda and dist.get_backend(group) == "gloo"):
        return out, inputs, lambda: out
    host = out.cpu()
    return host, tuple(t.cpu() for t in inputs), lambda: out.copy_(host)


def _tensors_by_dtype(module: torch.nn.Module) -> dict[torch.dtype, list[torch.Tensor]]:
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        groups.setdefault(t.dtype, []).append(t)
    return groups


@torch.no_grad()
def broadcast_from_rank0(module: torch.nn.Module) -> None:
    """Give every rank rank 0's parameters and buffers: one broadcast of a
    flat buffer per dtype. The first collective of a run, so it also
    connects the ranks while they are still in lockstep
    (``quickvc_tpu/train/loop.py:146-155``)."""
    if not is_distributed():
        return
    for tensors in _tensors_by_dtype(module).values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        staged, _, copy_back = gloo_staged(flat)
        dist.broadcast(staged, 0)
        copy_back()
        off = 0
        for t in tensors:
            t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


@dataclass(frozen=True)
class Zero1Partition:
    """Rank ``rank``'s shard of a network's parameters laid end to end.

    The flat vector of every parameter in order is padded with zeros to
    ``world * shard`` elements; rank r owns elements ``[r * shard, (r + 1) *
    shard)``. Its AdamW moments are that range's; the gradient arrives as
    that range of the mean (a reduce-scatter) and the updated parameters
    leave by an all-gather.
    """

    sizes: tuple[int, ...]   # elements of each parameter, in order
    world: int
    rank: int

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def shard(self) -> int:
        return max(1, math.ceil(self.total / self.world))

    @property
    def pieces(self) -> list[tuple[int, int, int]]:
        """(parameter index, first, end) of each parameter's elements in this
        rank's range, in order; the shard's zero padding follows them."""
        lo, hi = self.rank * self.shard, (self.rank + 1) * self.shard
        out, off = [], 0
        for i, n in enumerate(self.sizes):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                out.append((i, a - off, b - off))
            off += n
        return out

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every tensor end to end, zero-padded to ``world * shard``."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return torch.nn.functional.pad(flat, (0, self.world * self.shard - flat.numel()))

    def take(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's ``shard`` elements of the flattened tensors."""
        parts = [tensors[i].reshape(-1)[a:b] for i, a, b in self.pieces]
        flat = torch.cat(parts) if parts else tensors[0].new_zeros(0)
        return torch.nn.functional.pad(flat, (0, self.shard - flat.numel()))

    def split(self, flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Views of a gathered flat vector shaped as ``like``."""
        out, off = [], 0
        for t in like:
            out.append(flat[off : off + t.numel()].view_as(t))
            off += t.numel()
        return out


def zero1_partition(params: Sequence[torch.Tensor]) -> Zero1Partition:
    """This process's partition of ``params`` over the group's ranks."""
    return Zero1Partition(tuple(p.numel() for p in params), world_size(), rank())
