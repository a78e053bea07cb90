"""Ranks of the port's data-parallel tests: spawned processes over gloo.

Each rank is a fresh process (``spawn``) that imports torch and the port,
never JAX: the parent computes whatever JAX reference a test needs and
hands it over in files. The ranks meet through a ``file://`` rendezvous
under the test's ``tmp_path`` (no TCP port), take one torch thread each, and
write what they computed to ``tmp/rank{r}.pt`` for the parent to read.
"""

from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, tmp: str, job: str, args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                                         rank=rank, world_size=world)
    try:
        out = globals()[job](rank, world, tmp, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn(job: str, world: int, tmp, *args, timeout: float = 240.0) -> list:
    """Run ``job(rank, world, tmp, *args)`` of this module in ``world`` gloo
    ranks; returns each rank's result. A rank's exception is raised here
    with its traceback; past ``timeout`` seconds the ranks are killed."""
    tmp = str(tmp)
    ctx = mp.start_processes(_rank_main, args=(world, tmp, job, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job}: ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------
# jobs


def _case_state(case: dict, **train):
    from quickvc_tpu_torch.config import config_from_dict
    from quickvc_tpu_torch.train.state import build_models, create_train_state

    d = {k: dict(v) for k, v in case["config"].items()}
    d["train"].update(train)
    cfg = config_from_dict(d)
    net_g, net_d = build_models(cfg)
    net_g.load_state_dict(case["g"], strict=True)
    net_d.load_state_dict(case["d"], strict=True)
    return create_train_state(cfg, torch.device("cpu"), net_g, net_d)


def _rows(case: dict, rank: int, world: int) -> tuple[dict, torch.Tensor, torch.Tensor]:
    n = case["ids"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    batch = {k: torch.from_numpy(v[rows].copy()) for k, v in case["batch"].items()}
    return batch, torch.from_numpy(case["eps_q"][rows].copy()), torch.from_numpy(
        case["ids"][rows].copy())


def step_job(rank: int, world: int, tmp: str, variants: dict) -> dict:
    """One step of each variant (train-config overrides) from the case's
    weights on this rank's rows of its batch with its draws: the metrics,
    the reduced gradients, the parameters after, the optimizer state in
    plain AdamW's layout and the moment bytes this rank holds."""
    from quickvc_tpu_torch.train.state import optimizer_state_dict
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    case = torch.load(os.path.join(tmp, "case.pt"), weights_only=False)
    batch, eps_q, ids = _rows(case, rank, world)
    out = {}
    for name, train in variants.items():
        state = _case_state(case, **train)
        # torch's native CPU convolutions (tests/torch_train_support.py:port_step)
        with torch.backends.mkldnn.flags(enabled=False):
            m = train_step(state, batch, mel_basis(state.cfg, torch.device("cpu")),
                           eps_q=eps_q, ids_slice=ids, debug_grads=True)
        held = sum(v.numel() * v.element_size() for opt in (state.optim_g, state.optim_d)
                   for st in opt.state.values() for k, v in st.items() if k != "step")
        out[name] = {"metrics": m,
                     "g": {k: v.detach().clone() for k, v in state.net_g.state_dict().items()},
                     "d": {k: v.detach().clone() for k, v in state.net_d.state_dict().items()},
                     "opt_g": optimizer_state_dict(state, "g"),
                     "opt_d": optimizer_state_dict(state, "d"),
                     "moment_bytes": held}
    return out


def trainer_job(rank: int, world: int, tmp: str, runs: list[list[str]]) -> dict:
    """The trainer CLI (``loop.main``) with ``--distributed`` for each argv in
    ``runs``, one after another in this rank's process group; returns each
    run's summary."""
    from quickvc_tpu_torch.train import loop

    return {"summaries": [loop.main(argv + ["--distributed"]) for argv in runs]}
