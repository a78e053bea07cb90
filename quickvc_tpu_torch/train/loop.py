"""Training loop and CLI of the PyTorch/CUDA port.

    python -m quickvc_tpu_torch.train -c configs/quickvc.json -m NAME -mr ./logs
        [--max-steps N] [--device cuda|cpu] [--init-from-torch G.pth [D.pth]]
        [--export-torch-every N] [--deterministic] [--profile-steps N]
    torchrun --nproc-per-node N -m quickvc_tpu_torch.train --distributed ...

Port of ``quickvc_tpu/train/loop.py`` and ``train.py`` (reference
``train.py``): epochs over the length-bucketed loader (thread or process
workers), one :func:`train_step` per batch, the learning rate decayed once
per epoch; losses to stdout and ``model_dir/train.log``; TensorBoard event
files in ``model_dir`` (losses, step-wall percentiles, host RSS, mel images)
and ``model_dir/eval`` (the eval's metrics, mel images and audio), written
by :class:`quickvc_tpu_torch.utils.logging.Summarizer`; a stall warning and
a watchdog on the step walls; reconstruction and conversion eval on
``data.validation_files``; reference-format ``G_{n}.pth``/``D_{n}.pth``
checkpoints, the newest ``train.ckpt_max_to_keep`` of them kept. A run
resumes from the newest pair in ``model_dir``, mid-epoch included (the
loader skips the batches already trained on), and a resumed run takes the
same updates as an uninterrupted one: bit for bit on the CPU, and on the
card with ``--deterministic``; without it cuDNN picks its convolution
algorithms freely and may sum in another order from one run to the next,
so there the two agree to float32 rounding. The flag cost 13-21% of a
full-width float32 step on an H100 and -5% to +16% of a bf16 one, whose
free step itself read 0.126-0.294 s over six calls (``PERF.md``), so it
is opt-in. Past ``train.max_host_rss_gb`` the run checkpoints and exits
with code 75, which
``scripts/supervise_train.py -- python -m quickvc_tpu_torch.train ...``
answers with a relaunch.

``train.precision`` sets the step's compute dtype (``train/step.py``); the
eval runs in float32 whatever it is, as the JAX loop's does, and
checkpoints hold float32 parameters and moments either way.

Data parallel (``--distributed``, ``quickvc_tpu/train/loop.py:60-160``):
one process per card, started by ``torchrun``, each training on its own
``train.batch_size`` rows (the global batch is ``batch_size`` times the
number of processes; the sampler splits each global batch among the ranks)
and reducing the gradients over NCCL (:mod:`quickvc_tpu_torch.parallel`).
Every rank starts from rank 0's weights. Rank 0 writes ``train.log``,
rank r > 0 ``train.rank{r}.log``; TensorBoard events, the eval, checkpoints,
exports and their pruning are rank 0's alone, and the ranks meet at a
barrier after each save. Past ``train.max_host_rss_gb`` a multi-process run
only warns: one rank exiting alone would stall the others in their next
collective, so restarts belong to the launcher. With several processes
(``WORLD_SIZE`` > 1) and no ``--distributed`` the trainer raises rather
than train that many independent copies.

``--profile-steps N`` traces the steps whose update counter is 5 ... 4 + N
(``quickvc_tpu/train/loop.py:237-245``) with
:func:`quickvc_tpu_torch.utils.profiling.trace` into ``model_dir/profile``,
one Chrome-trace JSON a process (a rank's own under ``--distributed``); a
resumed run whose counter is already past 5 traces nothing. Unlike the JAX
loop, a run that stops inside the window (``--max-steps`` < 5 + N) stops
the trace and writes it on the way out. The traced steps' walls count in
``step_seconds`` as the others do.

Runs on the card unless ``--device cpu`` is given (gloo on the CPU); CUDA
without a card raises.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import numpy as np
import torch

from quickvc_tpu_torch.config import QuickVCConfig, get_config
from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                            UnitAudioSpecDataset)
from quickvc_tpu_torch.dsp.stft import spec_to_mel
from quickvc_tpu_torch.models.encoders import embed_utterance
from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
from quickvc_tpu_torch.ops.fused_mel import wave_to_mel
from quickvc_tpu_torch.parallel import mesh
from quickvc_tpu_torch.parallel.shard_step import rank_seed
from quickvc_tpu_torch.train.state import (build_models, create_train_state,
                                           load_optimizer_state_dict, optimizer_state_dict,
                                           set_epoch)
from quickvc_tpu_torch.train.step import mel_basis, train_step
from quickvc_tpu_torch.train.telemetry import (RESTART_EXIT_CODE, HostMemoryRestart,
                                               StepWallTracker, host_rss_gb)
from quickvc_tpu_torch.utils.checkpoint import (latest_step, load_checkpoint, prune_checkpoints,
                                                save_checkpoint)
from quickvc_tpu_torch.utils.device import resolve_device
from quickvc_tpu_torch.utils.logging import Summarizer, get_logger, plot_spectrogram
from quickvc_tpu_torch.utils.profiling import trace
from quickvc_tpu_torch.utils.weights import init_random_, load_discriminator, load_generator


def _upload(v: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of one wire array on ``device``; bf16 bit patterns (``uint16``,
    the compact wire's units at ``precision: "bf16"``) are viewed as
    ``torch.bfloat16`` after the copy."""
    if v.dtype == np.uint16:
        return torch.tensor(v.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(v, device=device)


PROFILE_FIRST_STEP = 5   # --profile-steps traces from the step whose counter is 5


def _pad_frames(x: np.ndarray, target: int) -> np.ndarray:
    """Reflect-pad the leading (frame) axis up to ``target`` rows."""
    out = x
    while out.shape[0] < target:
        take = min(target - out.shape[0], max(out.shape[0] - 1, 1))
        out = np.pad(out, [(0, take)] + [(0, 0)] * (out.ndim - 1),
                     mode="reflect" if out.shape[0] > 1 else "edge")
    return out


def evaluate(global_step: int, cfg: QuickVCConfig, net_g: SynthesizerTrn,
             eval_ds: UnitAudioSpecDataset, basis: torch.Tensor, writer: Summarizer,
             max_items: int = 7) -> dict:
    """Reconstruction and conversion eval on the first ``max_items`` items
    (reference train.py:196-222; ``quickvc_tpu/train/loop.py:evaluate``).

    Each item's units and spectrogram are reflect-padded to whole 1-s frame
    buckets, as the JAX eval pads them for its compiled shapes; its source
    mel is ``spec_to_mel`` of the spectrogram, its d-vector the mean over
    128-frame windows, and ``infer`` at noise 0 (kernel K3 on the card)
    resynthesises it, whose log-mel K1 takes on the card. Metrics and images
    are cropped back to the true frame count. ``eval/mel_l1`` is the log-mel
    L1 of the resynthesis, ``eval/spk_sim`` the cosine of its d-vector with
    the conditioning one. Then each item is converted to the most distinct
    other voice (argmin d-vector cosine): ``eval/vc_spk_sim`` scores the
    output against the target voice and ``eval/vc_spk_margin`` its margin
    over the source voice. Draws no random numbers; runs with ``net_g`` in
    eval mode under ``torch.inference_mode()`` and restores its mode.

    Returns ``{"scalars": the eval/* metrics, "vc_targets": the target of
    each item}``; empty when ``eval_ds`` is empty.
    """
    d = cfg.data
    hop = d.hop_length
    bucket = max(1, d.sampling_rate // hop)  # 1 s of frames
    device = basis.device

    def synth(unit, g_vec):
        y_hat = net_g.infer(unit.transpose(1, 2), g_vec, noise_scale=0.0)   # (1, 1, T)
        y_hat_mel = wave_to_mel(y_hat[:, 0], d.sampling_rate, d.filter_length, hop,
                                d.win_length, d.n_mel_channels, d.mel_fmin, d.mel_fmax)
        return y_hat[0, 0], y_hat_mel

    def unit_vector(g: torch.Tensor) -> np.ndarray:
        g = g.reshape(-1).cpu().numpy()
        return g / (np.linalg.norm(g) + 1e-8)

    was_training = net_g.training
    net_g.eval()
    mel_l1s, spk_sims, stash = [], [], []   # stash: (n, padded unit, d-vector) per item
    try:
        with torch.inference_mode():
            for i in range(min(max_items, len(eval_ds))):
                item = eval_ds[i]
                n = min(item["unit"].shape[0], item["spec"].shape[0])
                padded = int(np.ceil(n / bucket)) * bucket
                unit = torch.from_numpy(_pad_frames(item["unit"][:n], padded)[None]).to(device)
                spec = torch.from_numpy(_pad_frames(item["spec"][:n], padded)[None]).to(device)
                mel = spec_to_mel(spec, basis)                              # (1, P, 80)
                g_vec = embed_utterance(net_g.enc_spk, mel)                 # (1, gin)
                y_hat, y_hat_mel = synth(unit, g_vec)
                mel_n, y_hat_mel_n = mel[:, :n], y_hat_mel[:, :n]
                writer.images(global_step, {
                    f"gen/mel_{i}": plot_spectrogram(y_hat_mel_n[0].cpu().numpy().T),
                    f"gt/mel_{i}": plot_spectrogram(mel_n[0].cpu().numpy().T)})
                writer.audios(global_step, {f"gen/audio_{i}": y_hat[: n * hop].cpu().numpy(),
                                            f"gt/audio_{i}": item["wave"][:, 0]},
                              d.sampling_rate)
                mel_l1s.append(float((y_hat_mel_n - mel_n).abs().mean()))
                g_hat = embed_utterance(net_g.enc_spk, y_hat_mel_n)
                spk_sims.append(float((g_vec * g_hat).sum()
                                      / (g_vec.norm() * g_hat.norm() + 1e-8)))
                stash.append((n, unit, g_vec))
            vc_sims, vc_margins, targets = [], [], []
            if len(stash) >= 2:
                g_unit = np.stack([unit_vector(g) for _, _, g in stash])
                cos = g_unit @ g_unit.T
                np.fill_diagonal(cos, np.inf)
                targets = [int(j) for j in np.argmin(cos, axis=1)]
                for i, (n, unit, _) in enumerate(stash):
                    j = targets[i]
                    y_vc, y_vc_mel = synth(unit, stash[j][2])
                    g_hat = unit_vector(embed_utterance(net_g.enc_spk, y_vc_mel[:, :n]))
                    sim_t, sim_s = float(g_hat @ g_unit[j]), float(g_hat @ g_unit[i])
                    vc_sims.append(sim_t)
                    vc_margins.append(sim_t - sim_s)
                    if i == 0:
                        writer.audios(global_step, {"vc/audio_0": y_vc[: n * hop].cpu().numpy()},
                                      d.sampling_rate)
    finally:
        net_g.train(was_training)
    scalars = {}
    if mel_l1s:
        scalars = {"eval/mel_l1": float(np.mean(mel_l1s)),
                   "eval/spk_sim": float(np.mean(spk_sims))}
        if vc_sims:
            scalars["eval/vc_spk_sim"] = float(np.mean(vc_sims))
            scalars["eval/vc_spk_margin"] = float(np.mean(vc_margins))
        writer.scalars(global_step, scalars)
    writer.flush()
    return {"scalars": scalars, "vc_targets": targets}


def _initial_state(cfg: QuickVCConfig, device: torch.device,
                   init_torch: tuple[str, str | None] | None, log):
    """The newest checkpoint pair in ``model_dir`` (a resume, with its
    optimizers); else the reference-layout ``init_torch`` pair (G, D or
    None; G may be the JAX package's ``.msgpack``, which holds no step) with
    fresh optimizers and the step counter at G's ``iteration``; else seeded
    random weights."""
    resumed = latest_step(cfg.model_dir)
    if resumed is not None:
        state = create_train_state(cfg, device)
        for kind in "gd":
            net = state.nets(kind)[0]
            _, opt_sd = load_checkpoint(
                os.path.join(cfg.model_dir, f"{kind.upper()}_{resumed}.pth"), net)
            load_optimizer_state_dict(state, kind, opt_sd)
        state.step = resumed
        log.info("Resumed from checkpoint at step %d", resumed)
        return state
    if init_torch is None:
        return create_train_state(cfg, device)
    g_path, d_path = init_torch
    net_g, net_d = build_models(cfg)
    init_random_(net_g, cfg.train.seed)
    init_random_(net_d, cfg.train.seed + 1)
    load_generator(g_path, net_g)
    if d_path is not None:
        load_discriminator(d_path, net_d)
    state = create_train_state(cfg, device, net_g, net_d)
    if not g_path.endswith(".msgpack"):
        ckpt = torch.load(g_path, map_location="cpu", weights_only=True)
        state.step = int(ckpt.get("iteration") or 0) if isinstance(ckpt, dict) else 0
    log.info("Warm-started from torch checkpoint %s%s at iteration %d (fresh optimizers)",
             g_path, f" + {d_path}" if d_path else " (D from scratch)", state.step)
    return state


def _host_metrics(m: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """A step's metrics on the host: (scalars and vectors, the img/ arrays)."""
    host = {k: v.cpu().numpy() for k, v in m.items()}
    imgs = {k: host.pop(k) for k in list(host) if k.startswith("img/")}
    return host, imgs


def run(cfg: QuickVCConfig, device: torch.device, max_steps: int | None = None,
        init_torch: tuple[str, str | None] | None = None, profile_steps: int = 0) -> dict:
    """Train; returns {"steps", "losses" (one dict per step), "step_seconds"
    (batch upload, step and sync of each step), "log_seconds" (each log
    step's metrics read, images and event writes), "evals" (one dict per
    eval: its TensorBoard step, seconds and scalars), "checkpoint" (the last
    G/D paths written)}.

    Counting rule. ``g`` is the number of updates taken before a step (the
    JAX loop's ``global_step``). After the update, the step logs when ``g``
    is a multiple of ``log_interval``, evaluates and checkpoints when ``g``
    is a multiple of ``eval_interval``, and checkpoints again (an export)
    when ``g`` is a multiple of ``export_torch_every``: the JAX loop's
    points, so eval runs after updates 1, eval_interval + 1, .... TensorBoard
    events carry ``g`` as their step, as the JAX loop's do. Checkpoint files
    are named by the updates taken, ``g + 1``, which ``latest_step`` reads
    back as the counter on resume; the text log's "step" counts the same.
    Every checkpoint is a full reference-layout pair with its optimizer
    state, so an export is also a resume point; only non-export pairs past
    the newest ``ckpt_max_to_keep`` are deleted. The last step of
    ``max_steps``, and a host-memory restart, checkpoint too.

    ``profile_steps`` > 0 traces the steps with ``g`` in [5, 5 +
    ``profile_steps``) into ``model_dir/profile`` (the module docstring).
    """
    t = cfg.train
    rank, world = mesh.rank(), mesh.world_size()
    log = get_logger(cfg.model_dir, "train.log" if rank == 0 else f"train.rank{rank}.log")
    train_ds = UnitAudioSpecDataset("train", cfg, with_spec=cfg.train.transfer != "compact")
    eval_ds = UnitAudioSpecDataset("eval", cfg)
    sampler = BucketSampler(train_ds.lengths, cfg.train.batch_size, BUCKET_BOUNDARIES,
                            num_replicas=world, rank=rank)
    loader = DataLoader(train_ds, sampler, cfg, num_workers=cfg.train.loader_workers,
                        seed=cfg.train.seed, prefetch=cfg.train.prefetch_batches,
                        mode=cfg.train.loader_mode)
    if len(loader) == 0:
        raise ValueError(f"no utterance of {cfg.data.training_files} falls in a "
                         f"length bucket ({BUCKET_BOUNDARIES[0]}-"
                         f"{BUCKET_BOUNDARIES[-1]} frames)")
    state = _initial_state(cfg, device, init_torch, log)
    # rank 0's weights on every rank; the ranks' first collective, made while
    # they are still in lockstep
    mesh.broadcast_from_rank0(state.net_g)
    mesh.broadcast_from_rank0(state.net_d)
    log.info("Generator params: %.2fM | Discriminator params: %.2fM on %s (rank %d of %d)",
             sum(p.numel() for p in state.net_g.parameters()) / 1e6,
             sum(p.numel() for p in state.net_d.parameters()) / 1e6, device, rank, world)
    if t.max_host_rss_gb > 0 and world > 1:
        log.warning("train.max_host_rss_gb is single-process only (a lone rank exiting "
                    "would wedge the collective); RSS is still logged, but restarts belong "
                    "to the external launcher in multi-process runs")

    export_every = t.export_torch_every

    def save(lr: float, epoch: int) -> None:
        paths = tuple(os.path.join(cfg.model_dir, f"{k}_{state.step}.pth") for k in "GD")
        if out["checkpoint"] == paths:
            return  # this step's pair is already written
        # every rank: under ZeRO-1 the moments are gathered (a collective)
        opt_g, opt_d = optimizer_state_dict(state, "g"), optimizer_state_dict(state, "d")
        if rank == 0:
            save_checkpoint(paths[0], state.net_g, opt_g, lr, epoch)
            save_checkpoint(paths[1], state.net_d, opt_d, lr, epoch)
            log.info("saved %s", " and ".join(paths))
            prune_checkpoints(cfg.model_dir, t.ckpt_max_to_keep,
                              keep=lambda n: bool(export_every) and (n - 1) % export_every == 0)
        mesh.barrier()
        out["checkpoint"] = paths

    basis = mel_basis(cfg, device)
    gen = torch.Generator(device=device)
    epoch0 = state.step // len(loader) + 1
    set_epoch(state, epoch0)
    loader.skip_next_iter(state.step % len(loader))
    out = {"steps": state.step, "losses": [], "step_seconds": [], "log_seconds": [],
           "evals": [], "checkpoint": None}
    if max_steps is not None and state.step >= max_steps:
        return out
    writer = Summarizer(cfg.model_dir) if rank == 0 else None
    writer_eval = Summarizer(os.path.join(cfg.model_dir, "eval")) if rank == 0 else None
    walls = StepWallTracker()
    # warns while no step completes (a hung card or loader); stopped in the
    # finally, so it never outlives the run
    wd_stop = walls.watchdog(log, lambda: walls.total_steps)
    unhealthy = 0
    profile_dir = os.path.join(cfg.model_dir, "profile")
    tracing = None   # the open trace of profile_steps

    def stop_trace() -> None:
        nonlocal tracing
        if tracing is not None:
            tracing.__exit__(None, None, None)
            tracing = None
            log.info("profile trace written to %s", profile_dir)

    try:
        for epoch in range(epoch0, t.epochs + 1):
            sampler.set_epoch(epoch)
            lr = state.optim_g.param_groups[0]["lr"]
            t_iter = time.perf_counter()   # the step wall includes the wait for the batch
            for host_batch in loader:
                g = state.step
                if profile_steps and g in (PROFILE_FIRST_STEP, PROFILE_FIRST_STEP + profile_steps):
                    stop_trace()
                    if g == PROFILE_FIRST_STEP:
                        tracing = trace(profile_dir)
                        tracing.__enter__()
                        log.info("tracing steps %d-%d into %s", g, g + profile_steps - 1,
                                 profile_dir)
                    t_iter = time.perf_counter()   # the profiler's start or write is no step's
                t0 = time.perf_counter()
                # a copy: process workers' arrays live in shared memory they reuse
                batch = {k: _upload(v, device) for k, v in host_batch.items()}
                del host_batch
                gen.manual_seed(rank_seed(t.seed * 1_000_003 + g, rank))  # resumable draws
                m = train_step(state, batch, basis, generator=gen)
                scalars = {k: float(m[f"loss/{k}"])
                           for k in ("g/total", "d/total", "g/mel", "g/kl")}
                skipped = sum(float(m.get(f"guard/{k}_skipped", 0.0)) for k in "dg")
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                stall_median = walls.add(t1 - t_iter)
                if stall_median is not None:
                    log.warning("stall: step %d wall %.2f s > %.0fx running median %.3f s "
                                "(stall #%d this run)", state.step, t1 - t_iter,
                                walls.stall_factor, stall_median, walls.stalls)
                out["step_seconds"].append(t1 - t0)
                out["losses"].append(dict(scalars, step=state.step, skipped=skipped))
                out["steps"] = state.step
                if not all(math.isfinite(v) for v in scalars.values()) or skipped:
                    unhealthy += 1
                    guarded = t.guard_nonfinite or t.guard_loss_max > 0
                    if not guarded or unhealthy >= 10:
                        raise FloatingPointError(
                            f"unhealthy training at step {state.step}: {scalars}, "
                            f"{skipped:g} updates skipped; a restart resumes from "
                            "the last checkpoint")
                    log.warning("unhealthy step %d (%s); the guard left the params "
                                "untouched", state.step, scalars)
                else:
                    unhealthy = 0
                if g % t.log_interval == 0:
                    tl = time.perf_counter()
                    log.info("epoch %d step %d lr %.3e | g %.3f d %.3f mel %.3f kl %.3f "
                             "(%.3f s)", epoch, state.step, lr, scalars["g/total"],
                             scalars["d/total"], scalars["g/mel"], scalars["g/kl"],
                             out["step_seconds"][-1])
                    rss = host_rss_gb()
                    if writer is not None:
                        host, imgs = _host_metrics(m)
                        writer.scalars(g, host | walls.summary() | {"host/rss_gb": rss})
                        writer.images(g, {
                            "slice/mel_org": plot_spectrogram(imgs["img/mel_org"].T),
                            "slice/mel_gen": plot_spectrogram(imgs["img/mel_gen"].T),
                            "all/mel": plot_spectrogram(imgs["img/mel_all"].T)})
                        writer.flush()
                    out["log_seconds"].append(time.perf_counter() - tl)
                    if world == 1 and 0 < t.max_host_rss_gb < rss:
                        save(lr, epoch)
                        log.warning("host RSS %.2f GB > limit %.2f GB: checkpointed at step "
                                    "%d, requesting restart", rss, t.max_host_rss_gb,
                                    state.step)
                        raise HostMemoryRestart(rss, t.max_host_rss_gb, state.step)
                if t.eval_interval and g % t.eval_interval == 0:
                    if rank == 0:
                        te = time.perf_counter()
                        ev = evaluate(g, cfg, state.net_g, eval_ds, basis, writer_eval)
                        out["evals"].append({"step": g, "seconds": time.perf_counter() - te}
                                            | ev["scalars"])
                        if ev["scalars"]:
                            log.info("eval after update %d (TensorBoard step %d) | mel_l1 "
                                     "%.4f", state.step, g, ev["scalars"]["eval/mel_l1"])
                    save(lr, epoch)
                if export_every and g % export_every == 0:
                    save(lr, epoch)
                    if rank == 0:
                        log.info("exported reference-layout G_%d.pth/D_%d.pth", state.step,
                                 state.step)
                if max_steps is not None and state.step >= max_steps:
                    save(lr, epoch)
                    return out
                t_iter = time.perf_counter()
            state.sched_g.step()
            state.sched_d.step()
            log.info("====> Epoch %d done", epoch)
        return out
    finally:
        # a run that ends inside the window still writes its trace (the JAX
        # loop leaves it open)
        stop_trace()
        wd_stop.set()
        loader.close()
        if writer is not None:
            writer.close()
            writer_eval.close()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train QuickVC (PyTorch/CUDA port).")
    p.add_argument("-c", "--config", type=str, default="./configs/quickvc.json")
    p.add_argument("-m", "--model", type=str, default="quickvc")
    p.add_argument("-mr", "--modelroot", type=str, default="./logs")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop (and checkpoint) after N steps in all")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over the processes a launcher started "
                        "(torchrun --nproc-per-node N ...): NCCL on the cards "
                        "(cuda:LOCAL_RANK), gloo with --device cpu")
    p.add_argument("--export-torch-every", type=int, default=None, metavar="N",
                   help="also checkpoint after every update whose prior count is a "
                        "multiple of N (kept by the pruning); overrides "
                        "train.export_torch_every")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic algorithms on the card (cuDNN's and torch's, cuBLAS "
                        "with a fixed workspace), so that a resumed run equals an "
                        "uninterrupted one bit for bit; slower (PERF.md)")
    p.add_argument("--init-from-torch", type=str, nargs="+", default=None,
                   metavar=("G.pth", "D.pth"),
                   help="warm-start from reference-layout checkpoints (fresh "
                        "optimizers, the step counter at G's iteration; G may be "
                        "the JAX package's .msgpack, step 0); a checkpoint pair "
                        "in the model directory wins (a resume)")
    p.add_argument("--profile-steps", type=int, default=0, metavar="N",
                   help=f"trace the steps whose update counter is {PROFILE_FIRST_STEP} ... "
                        f"{PROFILE_FIRST_STEP - 1} + N into model_dir/profile (Chrome traces; "
                        "open them in ui.perfetto.dev)")
    args = p.parse_args(argv)
    if args.init_from_torch and len(args.init_from_torch) > 2:
        p.error("--init-from-torch takes G.pth [D.pth]")
    return args


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """Deterministic algorithms inside the block when ``on``: cuDNN's, every
    op of torch's (an op with no deterministic version raises rather than
    run), cuBLAS's on a fixed workspace. ``CUBLAS_WORKSPACE_CONFIG`` is read
    when the process makes its first cuBLAS handle, so the CLI enters this
    before anything touches the card. The flags are restored on the way out
    (the environment variable stays: cuBLAS has read it)."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[1:]


def main(argv=None) -> dict:
    args = parse_args(argv)
    with deterministic_algorithms(args.deterministic):
        return _main(args)


def _main(args: argparse.Namespace) -> dict:
    if mesh.launcher_world_size() > 1 and not args.distributed:
        raise RuntimeError(
            f"WORLD_SIZE={mesh.launcher_world_size()}: a launcher started several "
            "processes; pass --distributed so that they train one model together "
            "(without it each would train its own copy)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 products in float32: cuDNN convolutions would otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.config, args.model, args.modelroot)
    if args.export_torch_every is not None:
        cfg.train.export_torch_every = args.export_torch_every
    init_torch = None
    if args.init_from_torch:
        init_torch = (args.init_from_torch[0], (args.init_from_torch[1:] or [None])[0])
    created = False
    if args.distributed:
        device, created = mesh.init_process_group(device.type)
    try:
        return run(cfg, device, args.max_steps, init_torch, args.profile_steps)
    except HostMemoryRestart as e:
        # checkpointed: scripts/supervise_train.py (or any process manager)
        # relaunches on this code, and the run resumes where it stopped
        print(f"restart requested: {e}", flush=True)
        raise SystemExit(RESTART_EXIT_CODE) from e
    finally:
        if created:
            torch.distributed.destroy_process_group()
