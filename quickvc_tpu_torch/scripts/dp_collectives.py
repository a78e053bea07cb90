"""The data-parallel trainer's collectives on the cards of one host, timed.

    torchrun --standalone --nproc-per-node N -m quickvc_tpu_torch.scripts.dp_collectives \
        [-c configs/quickvc.json] [--iters 10]

Builds G and D at the config's widths and, for each network's flat
gradient buffer (the one the step reduces, ``parallel/shard_step.py``),
times over NCCL with CUDA events: the float32 all-reduce, the bf16 one
(``train.grad_reduce_dtype: "bf16"``), and ZeRO-1's reduce-scatter plus
all-gather, each with its bytes. Then the bf16 mean of seeded vectors
against ``round_bf16(a + b) / 2`` at two ranks (bit for bit, the JAX
step's arithmetic) and against the float32 mean at more. Rank 0 prints one
JSON line, beside the card's name and the number of ranks.
"""

from __future__ import annotations

import argparse
import json

import torch

from quickvc_tpu_torch.config import load_config
from quickvc_tpu_torch.parallel import mesh
from quickvc_tpu_torch.parallel.shard_step import all_gather, grad_reduce, grad_reduce_scatter
from quickvc_tpu_torch.train.state import build_models


def _event_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    mesh.barrier()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_mean_check(device: torch.device, n: int = 1 << 20, seed: int = 0) -> dict:
    """The bf16 gradient mean of every rank's seeded vector against the
    formula: at two ranks ``round_bf16(a + b) / 2`` bit for bit, at more the
    float32 mean of the bf16-rounded inputs (max error over max |mean|)."""
    world, rank = mesh.world_size(), mesh.rank()
    inputs = [torch.randn(n, generator=torch.Generator().manual_seed(seed + r)).to(device)
              for r in range(world)]
    got = grad_reduce([inputs[rank]], torch.bfloat16)()[0]
    rounded = [x.bfloat16().float() for x in inputs]
    out = {"ranks": world, "elements": n}
    if world == 2:
        want = ((rounded[0] + rounded[1]).bfloat16() / 2).float()
        out["bit_equal_to_round_bf16_sum_over_2"] = bool(torch.equal(got, want))
    mean = sum(rounded) / world
    out["max_err_over_max_vs_f32_mean"] = float((got - mean).abs().max() / mean.abs().max())
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-c", "--config", default="configs/quickvc.json")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    device, created = mesh.init_process_group("cuda")
    try:
        cfg = load_config(args.config)
        out = {"card": torch.cuda.get_device_name(device), "ranks": mesh.world_size(),
               "networks": {}}
        for name, net in zip("GD", build_models(cfg)):
            params = [p.to(device) for p in net.parameters()]
            grads = [torch.randn_like(p) for p in params]
            part = mesh.zero1_partition(params)

            def zero1():
                all_gather(part, grad_reduce_scatter(part, grads)())

            out["networks"][name] = {
                "elements": sum(g.numel() for g in grads),
                "f32_all_reduce_bytes": 4 * sum(g.numel() for g in grads),
                "f32_all_reduce_ms": _event_ms(lambda: grad_reduce(grads)(), args.iters),
                "bf16_all_reduce_bytes": 2 * sum(g.numel() for g in grads),
                "bf16_all_reduce_ms": _event_ms(
                    lambda: grad_reduce(grads, torch.bfloat16)(), args.iters),
                "zero1_reduce_scatter_all_gather_bytes": 2 * 4 * part.world * part.shard,
                "zero1_reduce_scatter_all_gather_ms": _event_ms(zero1, args.iters)}
        out["bf16_mean"] = bf16_mean_check(device)
        if mesh.rank() == 0:
            print("dp_collectives " + json.dumps(out), flush=True)
        return out
    finally:
        if created:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
