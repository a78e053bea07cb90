"""The speaker LSTM's bf16 recurrence on the card: two hand-written kernels,
``csrc/lstm_recurrence.cu``, behind a ``torch.autograd.Function``.

They replace no TPU kernel: the JAX package runs the recurrence as a
``lax.scan`` (``quickvc_tpu/models/encoders.py:89-125``, sequential order
at :74-87), which XLA compiles. At bf16 that scan carries ``h`` and ``c``
in bf16 and rounds every op of the cell; cuDNN's bf16 LSTM does not, and
its gradients fail the port's bf16 gate (``ROADMAP.md`` C, F2). So the
port runs the JAX recurrence itself, one layer a call:

  xp      (B, T, 4H)  the input projection x W_ih^T + b of every step (the
                      caller's ``torch.matmul``, as JAX computes it)
  w_hh    (4H, H)
  h       (B, T, H)   the output sequence, h_t = o_t * tanh(c_t)

every step as ``models/encoders.py``'s loop computes it in bf16: h W_hh^T
a float32 sum rounded once, added to xp_t and rounded, sigmoid, tanh and
each product and sum of the cell in float32 from bf16 operands, rounded to
bf16, gate order (i, f, g, o).

The backward is the gradient of that recurrence, rounded where torch's
autograd of those bf16 ops rounds (the carried dh and dc, each gate's
gradient, each product); dh_{t-1} = dgates_t W_hh a float32 sum rounded
once. It returns the gate gradients (B, T, 4H), which are xp's gradient;
W_hh's gradient, sum_t dgates_t^T h_{t-1}, is one large float32 product of
the saved sequences rounded once, outside the kernel, as are the caller's
gradients of W_ih, the bias and x (JAX's scan transpose leaves those
products to XLA).

:func:`lstm_forward_reference` and :func:`lstm_backward_reference` are the
plain versions, with the kernels' roundings; a CPU tensor takes them, a
CUDA tensor launches the kernels or raises. :func:`lstm_plan` is the
kernels' partition. :data:`STATS` and :data:`BACKWARD_STATS` count
launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quickvc_tpu_torch.ops._cuda import (KernelStats, check, device_sms, library, require_cuda,
                                         stream_ptr)

STATS = KernelStats("lstm_bf16")
BACKWARD_STATS = KernelStats("lstm_bf16_backward")
# csrc/lstm_recurrence.cu: CLUSTER, MAX_H, MAX_CHUNK
CLUSTER = 8          # CTAs a thread-block cluster
MAX_HIDDEN = 256     # the kernels hold W_hh's slices in registers up to this width
MAX_CHUNK = 32       # batch rows a cluster (the backward's gate buffers fill shared memory)


class LSTMPlan(NamedTuple):
    """How the kernels cut one layer: ``clusters`` clusters of ``cluster``
    CTAs, cluster k taking batch rows [k chunk, min((k + 1) chunk, B)) and
    CTA j of it hidden units [j units, (j + 1) units) with their four gate
    rows of W_hh."""
    cluster: int
    units: int
    clusters: int
    chunk: int

    def slices(self, batch: int) -> list[tuple[range, range]]:
        """(batch rows, hidden units) of every CTA, in launch order."""
        return [(range(k * self.chunk, min((k + 1) * self.chunk, batch)),
                 range(j * self.units, (j + 1) * self.units))
                for k in range(self.clusters) for j in range(self.cluster)]


def lstm_plan(batch: int, hidden: int, sm_count: int = 132) -> LSTMPlan:
    """The kernels' partition of a (batch, hidden) layer.

    Hidden units split over one cluster of CLUSTER CTAs (CTA j holds the
    4H/C gate rows of W_hh for its H/C units in the forward, W_hh's H/C
    columns in the backward); the batch over ceil(B / MAX_CHUNK) clusters
    of equal chunks (MAX_CHUNK: the backward's two (rows, 4H) gate buffers
    fill a CTA's shared memory at H = 256). Takes H a multiple of 16 up to
    MAX_HIDDEN (units even, so a CTA's gate columns fill whole 8-wide mma
    tiles) and any B whose clusters fit the card.
    """
    if hidden % 16 or not 16 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"lstm_plan: hidden size must be a multiple of 16 in [16, "
                         f"{MAX_HIDDEN}], got {hidden}")
    if batch < 1:
        raise ValueError(f"lstm_plan: need a batch of at least 1, got {batch}")
    clusters = -(-batch // MAX_CHUNK)
    chunk = -(-batch // clusters)
    if clusters * CLUSTER > sm_count:
        raise ValueError(f"lstm_plan: batch {batch} needs {clusters} clusters of {CLUSTER} "
                         f"CTAs, more than the card's {sm_count} SMs (at most "
                         f"{MAX_CHUNK * (sm_count // CLUSTER)} rows)")
    return LSTMPlan(CLUSTER, hidden // CLUSTER, clusters, chunk)


def lstm_forward_reference(xp: torch.Tensor, w_hh: torch.Tensor):
    """(h, act, c) of one layer, step by step in xp's dtype as
    ``models/encoders.py``'s loop computes it: h and c (B, T, H), act (B, T,
    4H) the activated gates (sigmoid i, sigmoid f, tanh g, sigmoid o) the
    backward reads."""
    b, t, g4 = xp.shape
    w = w_hh.T
    h = c = xp.new_zeros(b, g4 // 4)
    hs, acts, cs = [], [], []
    for s in range(t):
        i, f, g, o = (xp[:, s] + h @ w).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        acts.append(torch.cat([i, f, g, o], dim=-1))
    return torch.stack(hs, 1), torch.stack(acts, 1), torch.stack(cs, 1)


def _sigmoid_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch's sigmoid backward on the CPU at bf16: dy (1 - y) y in float32,
    rounded once."""
    return (dy.float() * (1 - y.float()) * y.float()).to(dy.dtype)


def _tanh_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch's tanh backward on the CPU at bf16: dy (1 - y^2) in float32,
    rounded once."""
    return (dy.float() * (1 - y.float() * y.float())).to(dy.dtype)


def lstm_backward_reference(dh_out: torch.Tensor, w_hh: torch.Tensor, act: torch.Tensor,
                            c: torch.Tensor) -> torch.Tensor:
    """The gate gradients dgates (B, T, 4H) from the output sequence's
    gradient dh_out (B, T, H) and the forward's saved act and c, in reverse
    time, rounded where torch's autograd of the forward's bf16 ops rounds."""
    t = c.shape[1]
    dgates = torch.empty_like(act)
    dh_rec = dc_next = None
    for s in reversed(range(t)):
        si, sf, tg, so = act[:, s].chunk(4, dim=-1)
        c_prev = c[:, s - 1] if s else torch.zeros_like(c[:, 0])
        dh = dh_out[:, s] if dh_rec is None else dh_out[:, s] + dh_rec
        tc = torch.tanh(c[:, s])
        d_so, d_tc = dh * tc, dh * so
        dc = _tanh_grad(d_tc, tc)
        if dc_next is not None:
            dc = dc + dc_next
        d_sf, dc_next = dc * c_prev, dc * sf
        d_si, d_tg = dc * tg, dc * si
        dgates[:, s] = torch.cat([_sigmoid_grad(d_si, si), _sigmoid_grad(d_sf, sf),
                                  _tanh_grad(d_tg, tg), _sigmoid_grad(d_so, so)], dim=-1)
        dh_rec = dgates[:, s] @ w_hh
    return dgates


def _plan(name: str, b: int, steps: int, hidden: int, *tensors: torch.Tensor) -> LSTMPlan:
    require_cuda(name, *tensors, dtypes=(torch.bfloat16,),
                 why="the recurrence is the JAX package's bf16 one; float32 runs nn.LSTM")
    if steps < 1:
        raise ValueError(f"{name}: need at least one step, got T={steps}")
    if any(z.data_ptr() % 16 for z in tensors):
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")
    return lstm_plan(b, hidden, device_sms(tensors[0].device.index or 0))


def lstm_forward_kernel(xp: torch.Tensor, w_hh: torch.Tensor):
    """Launch the forward kernel on CUDA bf16 xp (B, T, 4H) and w_hh (4H, H):
    (h, act, c) as :func:`lstm_forward_reference` returns them."""
    xp, w_hh = xp.contiguous(), w_hh.contiguous()
    b, steps, g4 = xp.shape
    hidden = g4 // 4
    if w_hh.shape != (g4, hidden):
        raise ValueError(f"lstm_forward: w_hh {tuple(w_hh.shape)} does not match xp "
                         f"{tuple(xp.shape)} (need (4H, H))")
    plan = _plan("lstm_forward", b, steps, hidden, xp, w_hh)
    h = xp.new_empty(b, steps, hidden)
    act = torch.empty_like(xp)
    c = torch.empty_like(h)
    check(library().qvc_lstm_forward_bf16(
        xp.data_ptr(), w_hh.data_ptr(), h.data_ptr(), act.data_ptr(), c.data_ptr(),
        b, steps, hidden, plan.chunk, stream_ptr(xp)), "lstm forward kernel")
    STATS.count()
    return h, act, c


def lstm_backward_kernel(dh_out: torch.Tensor, w_hh: torch.Tensor, act: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: dgates (B, T, 4H) as
    :func:`lstm_backward_reference` returns them."""
    dh_out, w_hh, act, c = (z.contiguous() for z in (dh_out, w_hh, act, c))
    b, steps, hidden = c.shape
    if (dh_out.shape != c.shape or act.shape != (b, steps, 4 * hidden)
            or w_hh.shape != (4 * hidden, hidden)):
        raise ValueError(f"lstm_backward: shapes do not match: dh {tuple(dh_out.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}, act {tuple(act.shape)}, c {tuple(c.shape)}")
    plan = _plan("lstm_backward", b, steps, hidden, dh_out, w_hh, act, c)
    dgates = torch.empty_like(act)
    check(library().qvc_lstm_backward_bf16(
        dh_out.data_ptr(), w_hh.data_ptr(), act.data_ptr(), c.data_ptr(), dgates.data_ptr(),
        b, steps, hidden, plan.chunk, stream_ptr(c)), "lstm backward kernel")
    BACKWARD_STATS.count()
    return dgates


class LSTMRecurrence(torch.autograd.Function):
    """h (B, T, H) = the recurrence of one layer over xp (B, T, 4H) with
    w_hh (4H, H), both bf16: the plain versions on the CPU, the kernels on
    the card."""

    @staticmethod
    def forward(ctx, xp, w_hh):
        if xp.device.type == "cpu":
            h, act, c = lstm_forward_reference(xp, w_hh)
        else:
            h, act, c = lstm_forward_kernel(xp, w_hh)
        ctx.save_for_backward(w_hh, h, act, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        w_hh, h, act, c = ctx.saved_tensors
        if dh.device.type == "cpu":
            dgates = lstm_backward_reference(dh.to(h.dtype), w_hh, act, c)
        else:
            dgates = lstm_backward_kernel(dh.to(h.dtype), w_hh, act, c)
        dw = None
        if ctx.needs_input_grad[1]:
            # sum_t dgates_t^T h_{t-1}: one float32 product, rounded once
            h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
            dw = (dgates.flatten(0, 1).float().T @ h_prev.flatten(0, 1).float()).to(h.dtype)
        return dgates, dw


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One layer's output sequence h (B, T, H), differentiable in xp and w_hh."""
    return LSTMRecurrence.apply(xp, w_hh)
