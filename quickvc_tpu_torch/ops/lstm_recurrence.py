"""The speaker LSTM's bf16 recurrence on the card: two hand-written kernels,
``csrc/lstm_recurrence.cu``, behind ``torch.autograd.Function``s.

They replace no TPU kernel: the JAX package runs the recurrence as a
``lax.scan`` (``quickvc_tpu/models/encoders.py:89-125``, sequential order
at :74-87), which XLA compiles. At bf16 that scan carries ``h`` and ``c``
in bf16 and rounds every op of the cell; cuDNN's bf16 LSTM does not, and
its gradients fail the port's bf16 gate (``ROADMAP.md`` C, F2). So the
port runs the JAX recurrence itself:

  xp      (B, T, 4H)  a layer's input projection x W_ih^T + b of every step
                      (layer 0's is the caller's ``torch.matmul``, as JAX
                      computes it)
  w_hh    (4H, H)
  h       (B, T, H)   the output sequence, h_t = o_t * tanh(c_t)

every step as ``models/encoders.py``'s loop computes it in bf16: h W_hh^T
a float32 sum rounded once, added to xp_t and rounded, sigmoid, tanh and
each product and sum of the cell in float32 from bf16 operands, rounded to
bf16, gate order (i, f, g, o).

:func:`lstm_stack` runs every layer's forward in one launch of the
forward kernel, the JAX package's wavefront schedule
(``quickvc_tpu/models/encoders.py:_wavefront``): layer l >= 1 computes its
projection per step from layer l - 1's new h, rounded as the per-layer
chain rounds it (``bf16(bf16(h W_ih^T) + b)``), ``skew`` steps behind it
(:func:`lstm_stack_plan`). :func:`lstm_recurrence` is one layer of it.

The backward is the gradient of that recurrence, every layer in one
launch of the backward kernel (:func:`lstm_stack_backward_kernel`), rounded
where torch's autograd of those bf16 ops rounds (the carried dh and dc,
each gate's gradient, each product); dh_{t-1} = dgates_t W_hh a float32 sum
rounded once. A lower layer's output gradient is the layer above's
projection ``dgates @ w_ih`` (a float32 sum rounded once, as autograd's bf16
mm rounds it), which the kernel computes per step and hands down the
stack, the layer below running behind (:func:`lstm_stack_backward_plan`).
It returns the gate gradients (L, B, T, 4H), each layer's xp gradient;
W_hh's gradient, sum_t dgates_t^T h_{t-1}, is one large float32 product of
the saved sequences rounded once, outside the kernel, as are W_ih's and the
biases' (JAX's scan transpose leaves those products to XLA).
:func:`lstm_backward_kernel` is one layer of it.

:func:`lstm_forward_reference`, :func:`lstm_stack_reference`,
:func:`lstm_backward_reference` and :func:`lstm_stack_backward_reference`
are the plain versions, with the kernels' roundings; a CPU tensor takes
them, a CUDA tensor launches the kernels or raises. :func:`lstm_plan` is
the forward's partition of a layer, :func:`lstm_stack_plan` its partition
of a stack, :func:`lstm_stack_backward_plan` the backward's.
:data:`STATS` (the forward kernel) and :data:`BACKWARD_STATS` (the backward
kernel), any depth, count launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quickvc_tpu_torch.ops._cuda import (KernelStats, check, device_sms, library, require_cuda,
                                         stream_ptr)

STATS = KernelStats("lstm_stack_bf16")
BACKWARD_STATS = KernelStats("lstm_stack_bf16_backward")
# csrc/lstm_recurrence.cu: CLUSTER, MAX_H, MAX_CHUNK, MAX_BACKWARD_CHUNK, MAX_LAYERS,
# MAX_SKEW, BACKWARD_STAGES, THREADS, WARPS
CLUSTER = 8          # CTAs a thread-block cluster
MAX_HIDDEN = 256     # the kernels hold W_hh's slices in registers up to this width
MAX_CHUNK = 32       # forward: batch rows a cluster
MAX_BACKWARD_CHUNK = 16  # backward: batch rows a cluster (W_ih's slice shares shared memory)
MAX_LAYERS = 4       # layers a launch runs
SKEW = 2             # steps a layer runs behind the one below (the kernel takes 2 .. 3)
BACKWARD_STAGES = 3  # backward: its ring of saved state, loaded two steps ahead
WARPS = 8            # warps a CTA
SMEM_BYTES = 232_448  # shared memory a CTA may use on an H100


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
    """The forward kernel's partition of a (batch, hidden) layer.

    Hidden units split over one cluster of CLUSTER CTAs (CTA j holds the
    4H/C gate rows of W_hh for its H/C units); the batch over ceil(B /
    MAX_CHUNK) clusters of equal chunks (the backward's chunks are smaller:
    :func:`lstm_stack_backward_plan`). Takes H a multiple of 16 up to
    MAX_HIDDEN (units even, so a CTA's gate columns fill whole 8-wide mma
    tiles) and any B whose clusters fit the card.
    """
    plan = _chunks(batch, hidden)
    if plan.clusters * CLUSTER > sm_count:
        raise ValueError(f"lstm_plan: batch {batch} needs {plan.clusters} clusters of {CLUSTER} "
                         f"CTAs, more than the card's {sm_count} SMs (at most "
                         f"{MAX_CHUNK * (sm_count // CLUSTER)} rows)")
    return plan


def _chunks(batch: int, hidden: int, max_chunk: int = MAX_CHUNK) -> LSTMPlan:
    if hidden % 16 or not 16 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"lstm_plan: hidden size must be a multiple of 16 in [16, "
                         f"{MAX_HIDDEN}], got {hidden}")
    if batch < 1:
        raise ValueError(f"lstm_plan: need a batch of at least 1, got {batch}")
    clusters = -(-batch // max_chunk)
    return LSTMPlan(CLUSTER, hidden // CLUSTER, clusters, -(-batch // clusters))


class StackPlan(NamedTuple):
    """How the forward kernel runs ``layers`` layers in one launch: every
    layer cut as ``layer`` cuts one, cluster (l, k) (launch order l
    ceil(B / chunk) + k) running layer l of chunk k, each layer at least
    ``skew`` steps behind the one below; ``clusters`` in all, all resident
    at once."""
    layers: int
    skew: int
    layer: LSTMPlan
    clusters: int

    def serial_steps(self, steps: int) -> int:
        """The chain of steps a launch of T steps waits through: T + (L - 1) skew."""
        return steps + (self.layers - 1) * self.skew


def lstm_stack_plan(batch: int, hidden: int, layers: int) -> StackPlan:
    """The forward kernel's partition of a (batch, hidden) stack of ``layers``.

    A layer is cut as :func:`lstm_plan` cuts it; the stack takes layers x
    ceil(B / MAX_CHUNK) clusters. Layer l + 1 reads layer l's h of step t
    once layer l has published it, loading it SKEW - 1 steps ahead into a
    ring of SKEW stages, so it runs SKEW steps behind. The clusters wait on
    each other, so the launch needs them all resident: the wrapper asks the
    card (``qvc_lstm_stack_max_clusters``) and raises if it holds fewer.
    """
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"lstm_stack_plan: the kernel runs 1 to {MAX_LAYERS} layers, "
                         f"got {layers}")
    layer = _chunks(batch, hidden)
    return StackPlan(layers, SKEW, layer, layers * layer.clusters)


class BackwardPlan(StackPlan):
    """How the backward kernel runs ``layers`` layers in one launch: as
    :class:`StackPlan` cuts the forward (chunks of at most
    MAX_BACKWARD_CHUNK rows), in reverse time, layer l - 1 reading its dh
    from layer l's projection ``skew`` steps behind it."""

    def shared_bytes(self, project: bool) -> int:
        """A CTA's shared memory (``csrc/lstm_recurrence.cu:Backward``): two
        dgates buffers, the warps' float32 partials (twice for a projecting
        layer >= 1), the staged gate gradients, the ring of saved state and,
        for a layer >= 1, W_ih's slice."""
        rows, hsz, u = 16 * -(-self.layer.chunk // 16), self.layer.units * CLUSTER, self.layer.units
        up, ldg = max(u, 8), 4 * hsz + 8
        red = WARPS * rows * up
        return (4 * rows * ldg + 4 * (2 if project else 1) * red + 8 * rows * u
                + 2 * BACKWARD_STAGES * 7 * rows * u + (2 * up * ldg if project else 0))


def lstm_stack_backward_plan(batch: int, hidden: int, layers: int) -> BackwardPlan:
    """The backward kernel's partition of a (batch, hidden) stack of ``layers``.

    Hidden units split over a cluster of CLUSTER CTAs as the forward splits
    them (CTA j holds W_hh's columns of its units), the batch over ceil(B /
    MAX_BACKWARD_CHUNK) clusters of equal chunks: a layer >= 1 also holds
    W_ih's columns of its units in shared memory, (4H x H / 8) bf16, which
    fits beside the gate buffers at 16 rows and not at 32. A layer's
    projection of step t reaches the layer below after the next step's k
    loop, and the layer below loads it BACKWARD_STAGES - 1 steps ahead: it
    runs BACKWARD_STAGES + 1 steps behind. The clusters wait on each other,
    so the wrapper asks the card (``qvc_lstm_stack_backward_max_clusters``)
    and raises if it holds fewer than a stack of two or more layers needs.
    """
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"lstm_stack_backward_plan: the kernel runs 1 to {MAX_LAYERS} layers, "
                         f"got {layers}")
    plan = _chunks(batch, hidden, MAX_BACKWARD_CHUNK)
    return BackwardPlan(layers, BACKWARD_STAGES + 1, plan, layers * plan.clusters)


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


def lstm_stack_reference(xp0: torch.Tensor, w_ih, b, w_hh):
    """(h, act, c) of every layer, (L, B, T, .), the plain versions chained:
    layer 0 from xp0, layer l >= 1 from the projection ``h @ w_ih[l - 1].T +
    b[l - 1]`` of layer l - 1's h in its dtype (the product rounded once,
    then the bias)."""
    outs, xp = [], xp0
    for layer, w in enumerate(w_hh):
        outs.append(lstm_forward_reference(xp, w))
        if layer + 1 < len(w_hh):
            xp = outs[-1][0] @ w_ih[layer].T + b[layer]
    return tuple(torch.stack(z) for z in zip(*outs))


def _sigmoid_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch's sigmoid backward on the CPU at bf16: dy (1 - y) y in float32,
    rounded once (in float64 at float64)."""
    f = torch.promote_types(dy.dtype, torch.float32)
    return (dy.to(f) * (1 - y.to(f)) * y.to(f)).to(dy.dtype)


def _tanh_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch's tanh backward on the CPU at bf16: dy (1 - y^2) in float32,
    rounded once (in float64 at float64)."""
    f = torch.promote_types(dy.dtype, torch.float32)
    return (dy.to(f) * (1 - y.to(f) * y.to(f))).to(dy.dtype)


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


def lstm_stack_backward_reference(dh_out: torch.Tensor, w_ih, w_hh, act: torch.Tensor,
                                  c: torch.Tensor) -> torch.Tensor:
    """Every layer's dgates (L, B, T, 4H) from the top layer's output
    gradient dh_out (B, T, H), the W_ih of layers 1 .. L-1, the W_hh of
    every layer and the forward's act and c (L, B, T, .): the plain
    backward of each layer, top down, a lower layer's dh the product
    ``dgates @ w_ih`` of the layer above in its dtype (rounded once)."""
    out, dh = [None] * len(w_hh), dh_out
    for layer in reversed(range(len(w_hh))):
        out[layer] = lstm_backward_reference(dh, w_hh[layer], act[layer], c[layer])
        if layer:
            dh = out[layer] @ w_ih[layer - 1]
    return torch.stack(out)


def _check(name: str, steps: int, *tensors: torch.Tensor) -> None:
    require_cuda(name, *tensors, dtypes=(torch.bfloat16,),
                 why="the recurrence is the JAX package's bf16 one; float32 runs nn.LSTM")
    if steps < 1:
        raise ValueError(f"{name}: need at least one step, got T={steps}")
    if any(z.data_ptr() % 16 for z in tensors):
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")


def _plan(name: str, b: int, steps: int, hidden: int, *tensors: torch.Tensor) -> LSTMPlan:
    _check(name, steps, *tensors)
    return lstm_plan(b, hidden, device_sms(tensors[0].device.index or 0))


def lstm_stack_kernel(xp0: torch.Tensor, w_ih, b, w_hh):
    """Launch the forward kernel on CUDA bf16 xp0 (B, T, 4H), the W_ih (4H, H)
    and biases (4H,) of layers 1 .. L-1 and the W_hh (4H, H) of every layer:
    (h, act, c) of every layer as :func:`lstm_stack_reference` returns them.
    Raises RuntimeError if the card cannot hold every cluster of the launch
    at once (the layers wait on each other; nothing is launched then)."""
    layers = len(w_hh)
    if len(w_ih) != layers - 1 or len(b) != layers - 1:
        raise ValueError(f"lstm_stack: {layers} layers take {layers - 1} W_ih and biases, got "
                         f"{len(w_ih)} and {len(b)}")
    xp0 = xp0.contiguous()
    batch, steps, g4 = xp0.shape
    hidden = g4 // 4
    if (any(w.shape != (g4, hidden) for w in (*w_hh, *w_ih))
            or any(z.shape != (g4,) for z in b)):
        raise ValueError(f"lstm_stack: W_hh {[tuple(w.shape) for w in w_hh]}, W_ih "
                         f"{[tuple(w.shape) for w in w_ih]} or biases do not match xp0 "
                         f"{tuple(xp0.shape)} (need (4H, H) and (4H,))")
    w_hh = torch.stack(list(w_hh))
    w_ih, b = (torch.stack(list(z)) if layers > 1 else None for z in (w_ih, b))
    tensors = [z for z in (xp0, w_hh, w_ih, b) if z is not None]
    _check("lstm_stack", steps, *tensors)
    plan = lstm_stack_plan(batch, hidden, layers)
    chunk = plan.layer.chunk
    if layers > 1:
        held = library().qvc_lstm_stack_max_clusters(batch, steps, hidden, chunk, layers,
                                                      plan.skew)
        if held < 0:
            check(-held, "lstm stack occupancy")
        if held < plan.clusters:
            raise RuntimeError(
                f"lstm_stack: {layers} layers of batch {batch} take {plan.clusters} clusters "
                f"of {CLUSTER} CTAs, all resident at once (each layer waits on the one below), "
                f"but the card holds {held}")
    h = xp0.new_empty(layers, batch, steps, hidden)
    act = xp0.new_empty(layers, batch, steps, g4)
    c = torch.empty_like(h)
    counters = torch.zeros(layers, plan.layer.clusters, dtype=torch.int32, device=xp0.device)
    check(library().qvc_lstm_stack_bf16(
        xp0.data_ptr(), None if w_ih is None else w_ih.data_ptr(),
        None if b is None else b.data_ptr(), w_hh.data_ptr(), h.data_ptr(), act.data_ptr(),
        c.data_ptr(), counters.data_ptr(), batch, steps, hidden, chunk, layers, plan.skew,
        stream_ptr(xp0)), "lstm stack kernel")
    STATS.count()
    return h, act, c


def lstm_forward_kernel(xp: torch.Tensor, w_hh: torch.Tensor):
    """One layer of the forward kernel on CUDA bf16 xp (B, T, 4H) and w_hh
    (4H, H): (h, act, c) as :func:`lstm_forward_reference` returns them."""
    b, steps, g4 = xp.shape
    if w_hh.shape != (g4, g4 // 4):
        raise ValueError(f"lstm_forward: w_hh {tuple(w_hh.shape)} does not match xp "
                         f"{tuple(xp.shape)} (need (4H, H))")
    _plan("lstm_forward", b, steps, g4 // 4, xp, w_hh)
    return tuple(z[0] for z in lstm_stack_kernel(xp, [], [], [w_hh]))


def lstm_stack_backward_kernel(dh_out: torch.Tensor, w_ih, w_hh, act: torch.Tensor,
                               c: torch.Tensor, return_dh: bool = False):
    """Launch the backward kernel once for a whole stack on CUDA bf16
    tensors: dgates (L, B, T, 4H) as :func:`lstm_stack_backward_reference`
    returns them; with ``return_dh`` also the lower layers' output
    gradients (L - 1, B, T, H) the kernel handed down (None for one layer).
    Raises RuntimeError if the card cannot hold every cluster of a stack of
    two or more layers at once (nothing is launched then)."""
    layers = len(w_hh)
    if len(w_ih) != layers - 1:
        raise ValueError(f"lstm_stack_backward: {layers} layers take {layers - 1} W_ih, got "
                         f"{len(w_ih)}")
    dh_out, act, c = (z.contiguous() for z in (dh_out, act, c))
    _, batch, steps, hidden = c.shape
    g4 = 4 * hidden
    if (c.shape[0] != layers or act.shape != (layers, batch, steps, g4)
            or dh_out.shape != c.shape[1:]
            or any(w.shape != (g4, hidden) for w in (*w_hh, *w_ih))):
        raise ValueError(f"lstm_stack_backward: shapes do not match: dh {tuple(dh_out.shape)}, "
                         f"act {tuple(act.shape)}, c {tuple(c.shape)}, W_hh "
                         f"{[tuple(w.shape) for w in w_hh]}, W_ih {[tuple(w.shape) for w in w_ih]}")
    w_hh = torch.stack(list(w_hh))
    w_ih = torch.stack(list(w_ih)) if layers > 1 else None
    tensors = [z for z in (dh_out, w_hh, w_ih, act, c) if z is not None]
    _check("lstm_stack_backward", steps, *tensors)
    plan = lstm_stack_backward_plan(batch, hidden, layers)
    chunk = plan.layer.chunk
    if layers > 1:
        held = library().qvc_lstm_stack_backward_max_clusters(batch, steps, hidden, chunk, layers)
        if held < 0:
            check(-held, "lstm stack backward occupancy")
        if held < plan.clusters:
            raise RuntimeError(
                f"lstm_stack_backward: {layers} layers of batch {batch} take {plan.clusters} "
                f"clusters of {CLUSTER} CTAs, all resident at once (each layer waits on the one "
                f"above), but the card holds {held}")
    dgates = act.new_empty(act.shape)
    dh_mid = c.new_empty(layers - 1, batch, steps, hidden) if layers > 1 else None
    counters = (torch.zeros(layers - 1, plan.layer.clusters, dtype=torch.int32, device=c.device)
                if layers > 1 else None)
    check(library().qvc_lstm_stack_backward_bf16(
        dh_out.data_ptr(), None if w_ih is None else w_ih.data_ptr(), w_hh.data_ptr(),
        act.data_ptr(), c.data_ptr(), dgates.data_ptr(),
        None if dh_mid is None else dh_mid.data_ptr(),
        None if counters is None else counters.data_ptr(), batch, steps, hidden, chunk, layers,
        stream_ptr(c)), "lstm stack backward kernel")
    BACKWARD_STATS.count()
    return (dgates, dh_mid) if return_dh else dgates


def lstm_backward_kernel(dh_out: torch.Tensor, w_hh: torch.Tensor, act: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """One layer of the backward kernel (a stack of one): dgates (B, T, 4H)
    as :func:`lstm_backward_reference` returns them."""
    b, steps, hidden = c.shape
    if (dh_out.shape != c.shape or act.shape != (b, steps, 4 * hidden)
            or w_hh.shape != (4 * hidden, hidden)):
        raise ValueError(f"lstm_backward: shapes do not match: dh {tuple(dh_out.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}, act {tuple(act.shape)}, c {tuple(c.shape)}")
    return lstm_stack_backward_kernel(dh_out, [], [w_hh], act[None], c[None])[0]


def _weight_grad(dgates: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """dW_hh = sum_t dgates_t^T h_{t-1}: one float32 product rounded once."""
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return (dgates.flatten(0, 1).float().T @ h_prev.flatten(0, 1).float()).to(h.dtype)


def _recurrence_backward(dh: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor,
                         act: torch.Tensor, c: torch.Tensor, need_dw: bool):
    """One layer's (dgates, dW_hh) from its output's gradient dh: the plain
    version on the CPU, the kernel on the card (None for dW_hh unless
    ``need_dw``)."""
    dh = dh.to(h.dtype)
    if dh.device.type == "cpu":
        dgates = lstm_backward_reference(dh, w_hh, act, c)
    else:
        dgates = lstm_backward_kernel(dh, w_hh, act, c)
    return dgates, _weight_grad(dgates, h) if need_dw else None


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
        return _recurrence_backward(dh, w_hh, h, act, c, ctx.needs_input_grad[1])


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One layer's output sequence h (B, T, H), differentiable in xp and w_hh."""
    return LSTMRecurrence.apply(xp, w_hh)


class LSTMStack(torch.autograd.Function):
    """The last layer's h (B, T, H) of a stack over xp0 (B, T, 4H): arguments
    xp0, then the W_hh of every layer, the W_ih and the biases of layers 1 ..
    L-1, all bf16. The forward is the plain stack on the CPU, one launch of
    the forward kernel on the card; it saves every layer's h, act and c. The
    backward is the plain stack backward on the CPU (layer L-1 .. 0 as
    :class:`LSTMRecurrence` runs each, the layer below's dh as torch's
    autograd of ``h @ w_ih.T + b`` computes it), one launch of the backward
    kernel on the card; W_hh's, W_ih's and the biases' gradients are
    torch's products of its dgates, so that on the CPU every output and
    gradient is the per-layer chain's, bit for bit."""

    @staticmethod
    def forward(ctx, xp0, *weights):
        layers = (len(weights) + 2) // 3
        w_hh, w_ih, b = weights[:layers], weights[layers:2 * layers - 1], weights[2 * layers - 1:]
        if xp0.device.type == "cpu":
            h, act, c = lstm_stack_reference(xp0, w_ih, b, w_hh)
        else:
            h, act, c = lstm_stack_kernel(xp0, w_ih, b, w_hh)
        ctx.layers = layers
        ctx.save_for_backward(h, act, c, *weights)
        return h[-1]

    @staticmethod
    def backward(ctx, dh):
        h, act, c, *weights = ctx.saved_tensors
        layers = ctx.layers
        w_hh, w_ih = weights[:layers], weights[layers:2 * layers - 1]
        need = ctx.needs_input_grad[1:]
        dh = dh.to(h.dtype)
        if dh.device.type == "cpu":
            dgates = lstm_stack_backward_reference(dh, w_ih, w_hh, act, c)
        else:
            dgates = lstm_stack_backward_kernel(dh, w_ih, w_hh, act, c)
        d_hh = [_weight_grad(dgates[layer], h[layer]) if need[layer] else None
                for layer in range(layers)]
        # h_below @ w.T + b: autograd's mm and sum, in its operand order
        d_ih = [dgates[layer].flatten(0, 1).t().mm(h[layer - 1].flatten(0, 1))
                for layer in range(1, layers)]
        d_b = [dgates[layer].sum((0, 1)) for layer in range(1, layers)]
        return (dgates[0], *d_hh, *d_ih, *d_b)


def lstm_stack(xp0: torch.Tensor, w_ih, b, w_hh) -> torch.Tensor:
    """The last layer's output sequence (B, T, H) of a stack: layer 0's
    projected input xp0 (B, T, 4H), the W_ih (4H, H) and biases (4H,) of
    layers 1 .. L-1 and the W_hh (4H, H) of every layer; differentiable in
    all of them."""
    return LSTMStack.apply(xp0, *w_hh, *w_ih, *b)
