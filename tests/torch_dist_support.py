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


class Ranks:
    """``world`` gloo ranks running ``job(rank, world, tmp, *args)`` of this
    module, started and not yet waited for (:func:`start`)."""

    def __init__(self, job: str, world: int, tmp, args: tuple, timeout: float):
        self.job, self.world, self.tmp = job, world, str(tmp)
        self.ctx = mp.start_processes(_rank_main, args=(world, self.tmp, job, args),
                                      nprocs=world, join=False, start_method="spawn")
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """Each rank's result. A rank's exception is raised here with its
        traceback; past the deadline the ranks are killed."""
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.job}: ranks still running past the deadline")
        finally:
            self.kill()
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]

    def kill(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def start(job: str, world: int, tmp, *args, timeout: float = 240.0) -> Ranks:
    """Start ``job`` in ``world`` gloo ranks meeting under ``tmp`` (one
    group a directory); ``join`` the result for their outputs."""
    return Ranks(job, world, tmp, args, timeout)


def spawn(job: str, world: int, tmp, *args, timeout: float = 240.0) -> list:
    """Run ``job(rank, world, tmp, *args)`` of this module in ``world`` gloo
    ranks; returns each rank's result. A rank's exception is raised here
    with its traceback; past ``timeout`` seconds the ranks are killed."""
    return start(job, world, tmp, *args, timeout=timeout).join()


# --------------------------------------------------------------------------
# jobs


# the multiband decoder's G holds the multistream one's parameters but these
MULTISTREAM_ONLY = ("dec.multistream_conv_post.", "dec.updown_filter")


def _case_state(case: dict, model: dict | None = None, tp=None, **train):
    """A train state from the case's weights, its config's train section
    updated by ``train`` and its model section by ``model`` (the multiband
    decoder takes the case's multistream G without its multistream-only
    tensors); ``tp`` as ``create_train_state`` takes it."""
    from quickvc_tpu_torch.config import config_from_dict
    from quickvc_tpu_torch.train.state import build_models, create_train_state

    d = {k: dict(v) for k, v in case["config"].items()}
    d["train"].update(train)
    d["model"].update(model or {})
    cfg = config_from_dict(d)
    net_g, net_d = build_models(cfg)
    g = case["g"]
    if cfg.model.decoder_kind == "mb_istft":
        g = {k: v for k, v in g.items() if not k.startswith(MULTISTREAM_ONLY)}
    net_g.load_state_dict(g, strict=True)
    net_d.load_state_dict(case["d"], strict=True)
    return create_train_state(cfg, torch.device("cpu"), net_g, net_d, tp=tp)


def _rows(case: dict, rank: int, world: int, batch: dict | None = None
          ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """This rank's rows of the case's batch (its arrays updated by ``batch``)
    and of its draws."""
    n = case["ids"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    arrays = case["batch"] | (batch or {})
    batch = {k: torch.from_numpy(v[rows].copy()) for k, v in arrays.items()}
    return batch, torch.from_numpy(case["eps_q"][rows].copy()), torch.from_numpy(
        case["ids"][rows].copy())


def step_job(rank: int, world: int, tmp: str, variants: dict) -> dict:
    """One step of each variant (train-config overrides; a "model" entry
    updates the model section, a "batch" entry the batch's arrays) from the
    case's weights on this rank's rows of its batch with its draws: the metrics,
    the reduced gradients, the parameters after, the optimizer state in
    plain AdamW's layout and the moment bytes this rank holds."""
    from quickvc_tpu_torch.train.state import optimizer_state_dict
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    case = torch.load(os.path.join(tmp, "case.pt"), weights_only=False)
    out = {}
    for name, train in variants.items():
        train = dict(train)
        batch, eps_q, ids = _rows(case, rank, world, train.pop("batch", None))
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


def tp_job(rank: int, world: int, tmp: str, data: int, model: int) -> dict:
    """Tensor parallelism on a (data, model) mesh, ``min_channels`` 16: one
    float32 step from the case's weights on this data index's rows with its
    draws (the metrics, gathered gradients, the whole parameters and the
    AdamW state after it, this rank's bytes), then a second step drawing
    from the generator seeded by the data index (the whole parameters
    after it); and ``infer`` of the case's G on the batch's units, sharded
    and whole, noise drawn from one seed."""
    from quickvc_tpu_torch.parallel import tp
    from quickvc_tpu_torch.train.state import optimizer_state_dict
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    case = torch.load(os.path.join(tmp, "case.pt"), weights_only=False)
    mesh = tp.mesh_2d(data, model)
    rows = tp.batch_rows(mesh, case["ids"].shape[0])
    batch = {k: torch.from_numpy(v[rows].copy()) for k, v in case["batch"].items()}
    state = _case_state(case, tp=(mesh, 16))
    basis = mel_basis(state.cfg, torch.device("cpu"))
    out = {"mesh": (mesh.data_rank, mesh.model_rank), "layout_g": state.net_g.tp_layout,
           "layout_d": state.net_d.tp_layout}
    with torch.backends.mkldnn.flags(enabled=False):
        m = train_step(state, batch, basis, eps_q=torch.from_numpy(case["eps_q"][rows].copy()),
                       ids_slice=torch.from_numpy(case["ids"][rows].copy()), debug_grads=True)
        out |= {"metrics": m, "g": tp.gather_state_dict(state.net_g),
                "d": tp.gather_state_dict(state.net_d),
                "opt_g": optimizer_state_dict(state, "g"),
                "opt_d": optimizer_state_dict(state, "d"),
                "bytes": {k: tp.local_bytes(*state.nets(k)[:2]) for k in "gd"}}
        gen = torch.Generator().manual_seed(tp.step_seed(7, mesh))
        train_step(state, batch, basis, generator=gen)
        out["second"] = {"g": tp.gather_state_dict(state.net_g),
                         "d": tp.gather_state_dict(state.net_d)}

        # infer: the case's G sharded against the same G whole
        whole = _case_state(case).net_g.eval()
        sharded = _case_state(case, tp=(mesh, 16)).net_g.eval()
        unit = torch.from_numpy(case["batch"]["unit"].copy()).transpose(1, 2)
        g_vec = torch.nn.functional.normalize(
            torch.randn(unit.shape[0], whole.enc_spk.linear.out_features,
                        generator=torch.Generator().manual_seed(3)), dim=1)
        with torch.inference_mode():
            out["infer"] = [net.infer(unit, g_vec, noise_scale=0.667,
                                      generator=torch.Generator().manual_seed(11))
                            for net in (sharded, whole)]
    return out
