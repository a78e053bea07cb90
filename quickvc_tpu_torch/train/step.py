"""One GAN training step: D update, then G against the updated D.

Port of ``quickvc_tpu/train/step.py:134-357`` (reference ``train.py:117-162``):

1. Decode the batch. Compact (``wave_s16``/``n_take``): the s16 crop / 32768,
   its spectrogram by kernel K4 on the card, frames and samples past
   ``n_take`` masked to zero; full: ``unit``/``spec``/``wave`` as given.
2. mel from spec; the generator forward, once (posterior sample, random
   segment slice, differentiable iSTFT head) -> y_hat; the target wave
   sliced to the same segment.
3. D phase: MPD(y, y_hat.detach()) paired; LSGAN loss; AdamW step of D.
4. G phase against the updated D, real and fake apart: LSGAN + feature
   matching + 45 * mel-L1 (``y_hat``'s mel by the differentiable
   :func:`quickvc_tpu_torch.dsp.stft.wave_to_mel`) + KL, and with
   ``model.mb_istft_vits`` the sub-band MR-STFT loss of the decoder's
   pre-synthesis bands against the PQMF analysis of the target segment
   (``quickvc_tpu/train/step.py:124-125, 281-286``; ``train.fft_sizes``,
   ``hop_sizes``, ``win_lengths``); AdamW step of G.

Precision (``train.precision``, ``quickvc_tpu/train/step.py:123-131,
186-215, 247-270``): at ``"bf16"`` the generator takes unit, spec and mel in
bf16 and its latents are cast back to float32; D takes the target and
generated waves in bf16 and its logits are cast to float32; the feature
maps stay bf16 into ``feature_loss``. The spectrogram (K4), the decoder's
head, the mel loss, KL and the rest run in float32, and so do the
parameters, their gradients and the AdamW moments.

The guard: a non-finite gradient or loss, or ``|loss| >= guard_loss_max``,
skips that network's optimizer step, so its params and moments stay as they
were. The step returns the JAX step's metric names as float32 tensors;
reading them syncs with the card.

Across processes (``quickvc_tpu/train/step.py:94-110, 244-256, 302-351``;
:mod:`quickvc_tpu_torch.parallel.shard_step`): D's gradients are reduced
over the ranks before D's guard and update, G's before G's, and the loss
scalars before each guard, so every rank takes the same update. With
``train.grad_reduce_dtype: "bf16"`` the gradients' mean is taken in bf16.
With ``train.zero_opt_state`` a network's gradients arrive as this rank's
ZeRO-1 shard of their mean (a reduce-scatter), AdamW updates that shard,
and an all-gather returns the whole network to every rank.

At a float32 reduce over more than one rank, two terms take their value
over every rank's rows, as JAX's float32 trainer computes them under GSPMD:
with ``model.mb_istft_vits`` the sub-band loss's spectral convergence is
one ratio (``losses.py:multi_resolution_stft_loss``), and each
feature-matching mean is rounded to the feature maps' dtype once, from the
global sum (``losses.py:feature_loss``), not per rank; at a bf16 reduce
both stay each rank's, as JAX's ``shard_map`` step has them.

Under tensor parallelism (``state.mesh``, :mod:`quickvc_tpu_torch.parallel.tp`)
the reduces above run over the data group; a split parameter's gradient is
this model rank's slice, so the guard's per-gradient sums and
``grad_norm/*`` add the slices' partial sums over the model group (one small
all-reduce) and take each replicated gradient once: the replicated step's
values. ``debug_grads`` gathers the slices.

``train.split_prior`` (``quickvc_tpu/train/step.py:183-200, 244-256``): the
generator's forward runs without the prior encoder
(:meth:`SynthesizerTrn.forward_posterior`); D's gradient reduce is issued
asynchronously, the prior (:meth:`SynthesizerTrn.prior_stats`) runs its
forward while it is in flight, then D's guard and update wait for it. The
results equal the unsplit step's on the same draws.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from quickvc_tpu_torch.dsp import pqmf
from quickvc_tpu_torch.dsp.mel import mel_filterbank
from quickvc_tpu_torch.dsp.stft import spec_to_mel, wave_to_mel
from quickvc_tpu_torch.losses import (discriminator_loss, feature_loss, generator_loss, kl_loss,
                                      own_rows, subband_stft_loss)
from quickvc_tpu_torch.ops.fused_mel import wave_to_spec_halo
from quickvc_tpu_torch.ops.slicing import slice_segments
from quickvc_tpu_torch.parallel.mesh import Zero1Partition
from quickvc_tpu_torch.parallel.shard_step import (all_gather, grad_reduce, grad_reduce_scatter,
                                                   scalar_reduce, shard_stats, sum_over_ranks)
from quickvc_tpu_torch.parallel.tp_layers import all_gather as model_all_gather
from quickvc_tpu_torch.parallel.tp_layers import all_reduce as model_all_reduce
from quickvc_tpu_torch.train.state import TrainState

STEP_SPAN = "quickvc_train_step"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}   # train.precision -> compute dtype
G_METRICS = ("loss/g/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl",
             "loss/g/subband", "loss/g", "img/mel_gen", "img/mel_org")


def mel_basis(cfg, device: torch.device) -> torch.Tensor:
    d = cfg.data
    return torch.as_tensor(mel_filterbank(d.sampling_rate, d.filter_length, d.n_mel_channels,
                                          d.mel_fmin, d.mel_fmax), device=device)


def decode_batch(batch: dict[str, torch.Tensor], cfg):
    """Either wire format -> unit (B, F, Cu), spec (B, F, Freq), wave (B, F*hop)."""
    if "wave_s16" not in batch:
        return batch["unit"], batch["spec"], batch["wave"][..., 0]
    d = cfg.data
    hop, pad = d.hop_length, (d.filter_length - d.hop_length) // 2
    unit = batch["unit"]
    wf = batch["wave_s16"].float() / 32768.0
    n_take = batch["n_take"].to(unit.device, torch.long)[:, None]
    frames = unit.shape[1]
    spec = wave_to_spec_halo(wf, d.filter_length, hop, d.win_length)
    spec = spec * (torch.arange(frames, device=unit.device)[None, :] < n_take)[..., None]
    wave = wf[:, pad:-pad] * (torch.arange(frames * hop, device=unit.device)[None, :]
                              < n_take * hop)
    return unit, spec, wave


def _guard_ok(leaf_sums: torch.Tensor, loss: torch.Tensor, cfg) -> bool:
    """True unless the update must be skipped (quickvc_tpu/train/step.py:45-78);
    ``leaf_sums`` holds each gradient's sum."""
    ok = torch.isfinite(loss)
    if cfg.train.guard_loss_max > 0:
        ok = ok & (loss.abs() < cfg.train.guard_loss_max)
    if cfg.train.guard_nonfinite:
        ok = ok & torch.isfinite(leaf_sums).all()
    return bool(ok)


def _global_norm(grads) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def _apply(optim: torch.optim.Optimizer, params, grads, ok: bool) -> None:
    if ok:
        for p, g in zip(params, grads):
            p.grad = g
        optim.step()
    for p in params:
        p.grad = None


@torch.no_grad()
def _apply_zero(optim: torch.optim.Optimizer, part: Zero1Partition, params,
                grad_shard: torch.Tensor, ok: bool) -> None:
    """ZeRO-1: AdamW on this rank's shard of the flattened parameters (read
    from the network, so a load or broadcast is always seen), then every
    rank's shard gathered back into the network. A skip is global."""
    if not ok:
        return
    shard = optim.param_groups[0]["params"][0]
    shard.copy_(part.take(params))
    shard.grad = grad_shard
    optim.step()
    shard.grad = None
    for p, v in zip(params, part.split(all_gather(part, shard), params)):
        p.copy_(v)


class _Update:
    """One network's way from its local gradients to its update: the
    cross-rank reduce (started by :meth:`start`, finished by :meth:`finish`),
    the guard's per-gradient sums, the gradient norm and the optimizer step,
    replicated or ZeRO-1."""

    def __init__(self, state: TrainState, kind: str):
        net, self.optim, self.part = state.nets(kind)
        self.names, self.params = zip(*net.named_parameters())
        self.reduce_dtype = DTYPES[state.cfg.train.grad_reduce_dtype]
        self.group = None if state.mesh is None else state.mesh.data_group
        self.axis = None if state.mesh is None else state.mesh.model_axis
        self.dims = [None if state.mesh is None else net.tp_layout[n] for n in self.names]

    def start(self, grads, async_op: bool = False):
        if self.part is not None:
            return grad_reduce_scatter(self.part, grads, async_op)
        return grad_reduce(grads, self.reduce_dtype, async_op, self.group)

    def finish(self, wait, loss: torch.Tensor, cfg, guard: bool):
        """(reduced gradients or shard, ok, norm)."""
        reduced = wait()
        if self.part is not None:
            sums, norms = shard_stats(self.part, reduced)
            norm = torch.linalg.vector_norm(norms)
        elif self.axis is not None:
            sums, norms = self._model_stats(reduced)
            norm = torch.linalg.vector_norm(norms)
        else:
            sums = torch.stack([g.sum() for g in reduced]) if guard else None
            norm = _global_norm(reduced)
        return reduced, (_guard_ok(sums, loss, cfg) if guard else True), norm

    def _model_stats(self, grads) -> tuple[torch.Tensor, torch.Tensor]:
        """(sum, 2-norm) of every gradient, whole: a split one's partial sums
        and sums of squares added over the model ranks, a replicated one's
        taken as this rank has it (the same on every model rank)."""
        stats = torch.stack([torch.stack([g.sum(), torch.sum(g * g)]) for g in grads], 1)
        split = torch.tensor([d is not None for d in self.dims], device=stats.device)
        summed = model_all_reduce(torch.where(split, stats, torch.zeros_like(stats)), self.axis)
        stats = torch.where(split, summed, stats)
        return stats[0], stats[1].sqrt()

    def apply(self, reduced, ok: bool) -> None:
        if self.part is not None:
            _apply_zero(self.optim, self.part, self.params, reduced, ok)
        else:
            _apply(self.optim, self.params, reduced, ok)

    def debug(self, reduced) -> dict[str, torch.Tensor]:
        if self.part is not None:
            reduced = self.part.split(all_gather(self.part, reduced), self.params)
        if self.axis is not None:
            reduced = [g if d is None else model_all_gather(g, d, self.axis)
                       for g, d in zip(reduced, self.dims)]
        return dict(zip(self.names, reduced))


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """No parameter gradients for ``module`` inside (its input's still flow)."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def train_step(state: TrainState, batch: dict[str, torch.Tensor], basis: torch.Tensor,
               generator: torch.Generator | None = None,
               eps_q: torch.Tensor | None = None, ids_slice: torch.Tensor | None = None,
               debug_grads: bool = False) -> dict[str, torch.Tensor]:
    """One step in place on ``state``. ``generator`` draws the posterior noise
    and slice starts; ``eps_q`` (B, inter, F) and ``ids_slice`` (B,) replace
    them. ``debug_grads`` adds ``debug/d_grads`` and ``debug/g_grads``
    (name -> gradient)."""
    cfg = state.cfg
    net_g, net_d = state.net_g, state.net_d
    t = cfg.train
    hop, seg_frames = cfg.data.hop_length, cfg.segment_frames
    guard = t.guard_nonfinite or t.guard_loss_max > 0
    dt = DTYPES[t.precision]
    upd_d, upd_g = _Update(state, "d"), _Update(state, "g")
    group = upd_g.group   # the data group under tensor parallelism, else every rank
    with torch.profiler.record_function(STEP_SPAN):
        unit, spec, wave = decode_batch(batch, cfg)
        mel = spec_to_mel(spec, basis)                                  # (B, F, 80)
        unit_in = unit.transpose(1, 2).to(dt)
        spec_in, mel_in = spec.transpose(1, 2).to(dt), mel.transpose(1, 2).to(dt)
        if t.split_prior:
            y_hat, y_hat_mb, ids, posterior = net_g.forward_posterior(
                spec_in, mel_in, generator, eps_q, ids_slice)
            z, z_p, m_q, logs_q = (x.float() for x in posterior)
        else:
            y_hat, y_hat_mb, ids, latents = net_g(unit_in, spec_in, mel_in, generator, eps_q,
                                                  ids_slice)
            z, z_p, m_p, logs_p, m_q, logs_q = (x.float() for x in latents)
        y_seg = slice_segments(wave[:, None], ids * hop, t.segment_size)

        def disc(y_fake, pair):
            logits_r, logits_g, fmap_r, fmap_g = net_d(y_seg.to(dt), y_fake.to(dt), pair=pair)
            return ([l.float() for l in logits_r], [l.float() for l in logits_g],
                    fmap_r, fmap_g)

        # ---- D phase ----
        logits_r, logits_g, _, _ = disc(y_hat.detach(), True)
        loss_disc, losses_d_r, losses_d_g = discriminator_loss(logits_r, logits_g)
        d_grads = torch.autograd.grad(loss_disc, upd_d.params)
        wait_d = upd_d.start(d_grads, async_op=t.split_prior)
        if t.split_prior:
            # the prior's forward while D's gradient reduce is in flight
            m_p, logs_p = (x.float() for x in net_g.prior_stats(unit_in))
        # reduced before the guard: every rank must take the same decision
        loss_disc, losses_d_r, losses_d_g = scalar_reduce([loss_disc, losses_d_r, losses_d_g],
                                                          group)
        d_grads, d_ok, d_norm = upd_d.finish(wait_d, loss_disc, cfg, guard)
        upd_d.apply(d_grads, d_ok)

        # ---- G phase, against the updated D ----
        with _frozen(net_d):
            logits_r, logits_g, fmap_r, fmap_g = disc(y_hat, False)
        d = cfg.data
        y_hat_mel = wave_to_mel(y_hat[:, 0], basis, d.filter_length, hop, d.win_length)
        y_mel = slice_segments(mel.transpose(1, 2), ids, seg_frames).transpose(1, 2)
        loss_mel = t.c_mel * torch.mean(torch.abs(y_mel - y_hat_mel))
        loss_kl = t.c_kl * kl_loss(z_p, logs_q, m_p, logs_p)
        # the batch-wide terms over every rank's rows at a float32 reduce, each
        # rank's own at bf16 (JAX's shard_map step)
        sum_ranks = (functools.partial(sum_over_ranks, group=group)
                     if t.grad_reduce_dtype == "f32" else own_rows)
        loss_fm = feature_loss(fmap_r, fmap_g, sum_ranks)
        loss_gen, gen_losses = generator_loss(logits_g)
        if cfg.model.mb_istft_vits:
            y_mb = pqmf.analysis(y_seg, cfg.model.subbands)              # (B, s, T / s)
            loss_sub = subband_stft_loss(y_mb, y_hat_mb, t.fft_sizes, t.hop_sizes,
                                         t.win_lengths, sum_ranks)
        else:
            loss_sub = torch.zeros((), device=loss_mel.device)
        loss_g_total = loss_gen + loss_fm + loss_mel + loss_kl + loss_sub
        g_grads = torch.autograd.grad(loss_g_total, upd_g.params, allow_unused=True)
        g_grads = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(upd_g.params, g_grads)]
        wait_g = upd_g.start(g_grads)
        g_metrics = {
            "loss/g/total": loss_g_total, "loss/g/gen": loss_gen, "loss/g/fm": loss_fm,
            "loss/g/mel": loss_mel, "loss/g/kl": loss_kl, "loss/g/subband": loss_sub,
            "loss/g": gen_losses, "img/mel_gen": y_hat_mel[0], "img/mel_org": y_mel[0],
            "img/mel_all": mel[0]}
        g_metrics = dict(zip(g_metrics, scalar_reduce(list(g_metrics.values()), group)))
        g_grads, g_ok, g_norm = upd_g.finish(wait_g, g_metrics["loss/g/total"], cfg, guard)
        upd_g.apply(g_grads, g_ok)
    state.step += 1

    metrics = {k: g_metrics[k] for k in G_METRICS} | {
        "loss/d/total": loss_disc, "loss/d/r": losses_d_r, "loss/d/g": losses_d_g,
        "img/mel_all": g_metrics["img/mel_all"], "grad_norm/d": d_norm, "grad_norm/g": g_norm}
    metrics = {k: v.detach().float() for k, v in metrics.items()}
    if guard:
        metrics["guard/d_skipped"] = torch.tensor(0.0 if d_ok else 1.0)
        metrics["guard/g_skipped"] = torch.tensor(0.0 if g_ok else 1.0)
    if debug_grads:
        metrics["debug/d_grads"] = upd_d.debug(d_grads)
        metrics["debug/g_grads"] = upd_g.debug(g_grads)
    return metrics
