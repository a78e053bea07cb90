"""PyTorch port, the speaker LSTM's bf16 backward as one wavefront launch
(``ops/lstm_recurrence.py:lstm_stack_backward_kernel``,
``csrc/lstm_recurrence.cu:lstm_stack_backward_kernel``) on the CPU: its
plan (chunks, skew, shared memory), a numpy model of the kernel cluster by
cluster and CTA by CTA on the reverse wavefront (each layer's projection of
its gate gradients handed down the stack through the step counters, every
load only once its count is published) against the plain stack backward
bit for bit, the wrapper through a fake library, and the swap of the card's
path to the plain versions. No JAX; bit-equal comparisons, no tolerances.
"""

import numpy as np
import pytest
import torch

from torch_port_support import bf16_values

from quickvc_tpu_torch.ops import lstm_recurrence as lr
from quickvc_tpu_torch.ops._cuda import require_dtype
from quickvc_tpu_torch.utils import bf16

BF = torch.bfloat16


def bf16_round(x) -> np.ndarray:
    return bf16_values(bf16.to_bits(np.asarray(x, np.float32)))


def _sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(np.float32)


@pytest.mark.parametrize("batch,hidden,layers", [(32, 256, 3), (37, 32, 3), (2, 16, 1),
                                                 (80, 64, 4), (16, 48, 2)])
def test_backward_plan_covers_each_layer_unit_once(batch, hidden, layers):
    """L x ceil(B / 16) clusters, each a layer's (rows, units) cut as the
    forward cuts a layer but in chunks of at most 16 rows; a layer runs
    BACKWARD_STAGES + 1 steps behind the one above; a projecting layer's
    shared memory fits the card at every width."""
    plan = lr.lstm_stack_backward_plan(batch, hidden, layers)
    assert plan.layers == layers and plan.skew == lr.BACKWARD_STAGES + 1
    assert plan.layer.chunk <= lr.MAX_BACKWARD_CHUNK
    assert plan.clusters == layers * -(-batch // lr.MAX_BACKWARD_CHUNK)
    assert plan.serial_steps(512) == 512 + (layers - 1) * plan.skew
    seen = np.zeros((layers, batch, hidden), int)
    for layer in range(layers):
        for rows, units in plan.layer.slices(batch):
            seen[layer][np.ix_(list(rows), list(units))] += 1
    assert (seen == 1).all()
    assert plan.shared_bytes(True) <= lr.SMEM_BYTES
    assert plan.shared_bytes(False) < plan.shared_bytes(True)


def test_backward_plan_takes_16_rows_because_32_do_not_fit():
    """At the training batch's width (H 256) a projecting layer's CTA needs
    190,464 bytes at 16 rows; at the forward's 32 rows it would need more
    than an H100 gives a CTA (a layer that does not project, the kernel's
    old one-layer layout, 216,064 bytes)."""
    plan = lr.lstm_stack_backward_plan(32, 256, 3)
    assert (plan.layer.clusters, plan.layer.chunk, plan.clusters) == (2, 16, 6)
    assert plan.shared_bytes(True) == 190_464
    wide = plan._replace(layer=lr.lstm_plan(32, 256))
    assert wide.layer.chunk == 32
    assert wide.shared_bytes(False) == 216_064
    assert wide.shared_bytes(True) > lr.SMEM_BYTES
    with pytest.raises(ValueError, match="1 to 4 layers"):
        lr.lstm_stack_backward_plan(32, 256, lr.MAX_LAYERS + 1)


def stack_backward_model(dh_out, w_ih, w_hh, act, c, plan: lr.BackwardPlan) -> np.ndarray:
    """The backward kernel in numpy, on its reverse wavefront: at tick k,
    layer l runs its iteration k - (L - 1 - l) skew, every chunk's cluster
    CTA by CTA. A layer below the top reads dh of step s from the layer
    above's projection, which it may load (BACKWARD_STAGES - 1 steps ahead,
    as the kernel does) only once that layer's counter for its chunk says
    T - s steps are published: the model asserts it never loads earlier.
    Iteration it of a layer takes dgates_{s+1} (s = T - 1 - it) of the
    whole chunk from its buffer (columns grouped by CTA: 4U jj + 4 u' + q),
    multiplies it by W_hh's columns of CTA j's units (the recurrence) and,
    in a layer l >= 1, by W_ih,l's columns of the same units (the layer
    below's dh_{s+1}, a float32 sum rounded once, published after the
    cluster barrier as count it); then the cell's gradient. A layer >= 1
    runs one more iteration for dh_0. Each (layer, row, step, unit) and
    each dh is written exactly once."""
    layers, b, t, hsz = c.shape
    u, chunks, chunk = plan.layer.units, plan.layer.clusters, plan.layer.chunk
    ahead = lr.BACKWARD_STAGES - 1
    order = [q * hsz + jj * u + up for jj in range(plan.layer.cluster) for up in range(u)
             for q in range(4)]
    dgates = np.full((layers, b, t, 4 * hsz), np.nan, np.float32)
    dh_mid = np.full((max(layers - 1, 1), b, t, hsz), np.nan, np.float32)
    count = np.zeros((max(layers - 1, 1), chunks), int)
    state = {}
    for k in range(plan.serial_steps(t) + 1):
        published = []
        for layer in range(layers):
            it = k - (layers - 1 - layer) * plan.skew
            if not 0 <= it < t + (1 if layer else 0):
                continue
            s = t - 1 - it
            top = layer + 1 == layers
            dh_in = dh_out if top else dh_mid[layer]
            for kc in range(chunks):
                rows = slice(kc * chunk, min((kc + 1) * chunk, b))
                n = rows.stop - rows.start
                if not top and s >= 0:   # this iteration's loads of dh: steps it, ahead of it
                    first = t - 1 if it == 0 else s - ahead
                    for step in range(first, s - ahead - 1, -1):
                        if step >= 0:
                            assert count[layer, kc] >= t - step, (layer, kc, it, step)
                g_buf, dc_next = state.get((layer, kc), (None, np.zeros((plan.layer.cluster, n, u),
                                                                          np.float32)))
                new_g = np.full((n, 4 * hsz), np.nan, np.float32)
                for j in range(plan.layer.cluster):
                    us = slice(j * u, (j + 1) * u)
                    if layer and g_buf is not None:   # the layer below's dh_{s+1}
                        proj = g_buf.astype(np.float64) @ w_ih[layer - 1][order][:, us].astype(
                            np.float64)
                        assert np.isnan(dh_mid[layer - 1, rows, s + 1, us]).all()
                        dh_mid[layer - 1, rows, s + 1, us] = bf16_round(proj.astype(np.float32))
                    if s < 0:
                        continue
                    dh = dh_in[rows, s, us]
                    assert not np.isnan(dh).any()
                    if g_buf is not None:
                        rec = g_buf.astype(np.float64) @ w_hh[layer][order][:, us].astype(
                            np.float64)
                        dh = bf16_round(dh + bf16_round(rec.astype(np.float32)))
                    si, sf, tg, so = (act[layer, rows, s, q * hsz + j * u: q * hsz + (j + 1) * u]
                                      for q in range(4))
                    c_prev = c[layer, rows, s - 1, us] if s else np.zeros((n, u), np.float32)
                    tc = bf16_round(np.tanh(c[layer, rows, s, us]))
                    d_so, d_tc = bf16_round(dh * tc), bf16_round(dh * so)
                    dc = bf16_round(d_tc * (1 - tc * tc))
                    if g_buf is not None:
                        dc = bf16_round(dc + dc_next[j])
                    d_sf, dc_next[j] = bf16_round(dc * c_prev), bf16_round(dc * sf)
                    d_si, d_tg = bf16_round(dc * tg), bf16_round(dc * si)
                    grads = [bf16_round(d_si * (1 - si) * si), bf16_round(d_sf * (1 - sf) * sf),
                             bf16_round(d_tg * (1 - tg * tg)), bf16_round(d_so * (1 - so) * so)]
                    for q, gq in enumerate(grads):
                        at = slice(q * hsz + j * u, q * hsz + (j + 1) * u)
                        assert np.isnan(dgates[layer, rows, s, at]).all()
                        dgates[layer, rows, s, at] = gq
                        new_g[:, [4 * u * j + 4 * up + q for up in range(u)]] = gq
                assert s < 0 or not np.isnan(new_g).any()
                state[(layer, kc)] = (new_g, dc_next)
                if layer and it > 0:
                    published.append((layer - 1, kc, it))
        for layer, kc, steps in published:   # after the cluster barrier that ends the iteration
            count[layer, kc] = steps
    assert not np.isnan(dgates).any()
    assert layers == 1 or (count == t).all() and not np.isnan(dh_mid).any()
    return dgates


def _inputs(batch, hidden, layers, seed, steps=9):
    """A forward's saved act and c (the plain stack on bf16 inputs), the
    top layer's output gradient and the weights, as numpy float32 holding
    bf16 values."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape, scale=1.0: bf16_round(scale * rng.standard_normal(shape))  # noqa: E731
    xp = draw(batch, steps, 4 * hidden)
    w_hh = [draw(4 * hidden, hidden, scale=0.4) for _ in range(layers)]
    w_ih = [draw(4 * hidden, hidden, scale=0.4) for _ in range(layers - 1)]
    b = [draw(4 * hidden, scale=0.2) for _ in range(layers - 1)]
    dh = draw(batch, steps, hidden)
    t = lambda a: torch.from_numpy(a).to(BF)  # noqa: E731
    with torch.no_grad():
        _, act, c = lr.lstm_stack_reference(t(xp), [t(w) for w in w_ih], [t(z) for z in b],
                                            [t(w) for w in w_hh])
    return dh, w_ih, w_hh, act.float().numpy(), c.float().numpy()


@pytest.mark.parametrize("batch,hidden,layers", [(3, 16, 3), (37, 32, 3), (5, 16, 1),
                                                 (20, 16, 4)])
def test_stack_backward_model_matches_the_plain_chain(batch, hidden, layers):
    """Three layers of one chunk (two units a CTA), three layers of three
    chunks of 13 rows (four units a CTA), one layer, and four layers of two
    chunks: every layer's dgates bit-equal to the plain stack backward (the
    per-layer plain backward chained through ``dgates @ w_ih``)."""
    dh, w_ih, w_hh, act, c = _inputs(batch, hidden, layers, batch + hidden)
    model = stack_backward_model(dh, w_ih, w_hh, act, c,
                                 lr.lstm_stack_backward_plan(batch, hidden, layers))
    t = lambda a: torch.from_numpy(a).to(BF)  # noqa: E731
    with torch.no_grad():
        want = lr.lstm_stack_backward_reference(t(dh), [t(w) for w in w_ih],
                                                [t(w) for w in w_hh], t(act), t(c))
    np.testing.assert_array_equal(model, want.float().numpy())


def test_the_skew_is_the_least_the_hand_over_allows():
    """A layer one step closer to the layer above than the plan's skew
    would load a dh that is not yet published: the model's schedule
    refuses it."""
    dh, w_ih, w_hh, act, c = _inputs(3, 16, 2, 7)
    plan = lr.lstm_stack_backward_plan(3, 16, 2)
    stack_backward_model(dh, w_ih, w_hh, act, c, plan)
    with pytest.raises(AssertionError):
        stack_backward_model(dh, w_ih, w_hh, act, c, plan._replace(skew=plan.skew - 1))


class FakeLib:
    """The kernel library, recording each call; the card holds ``held``
    clusters of a stack kernel at once."""

    def __init__(self, held: int = 16):
        self.calls, self.held = [], held

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.held if name.endswith("_max_clusters") else 0
        return call


def _fake(monkeypatch, held: int = 16) -> FakeLib:
    lib = FakeLib(held)
    monkeypatch.setattr(lr, "library", lambda: lib)
    monkeypatch.setattr(lr, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(lr, "device_sms", lambda index: 132)
    monkeypatch.setattr(lr, "require_cuda",
                        lambda name, *ts, **kw: require_dtype(name, *ts, **kw))
    return lib


def test_stack_backward_wrapper_hands_the_kernel_its_plan(monkeypatch):
    """Three layers: the wrapper asks the card how many of the plan's
    clusters it holds at once, launches the backward entry once with every
    layer's W_hh and the upper layers' W_ih stacked, dh scratch for the two
    lower layers and zeroed counters, and counts one launch; it raises
    RuntimeError naming both numbers, and launches nothing, when the card
    holds fewer clusters than the plan needs."""
    lib = _fake(monkeypatch, held=16)
    hsz, b, steps = 64, 40, 5
    w = [torch.full((4 * hsz, hsz), float(i), dtype=BF) for i in range(5)]
    act = torch.zeros(3, b, steps, 4 * hsz, dtype=BF)
    c = torch.zeros(3, b, steps, hsz, dtype=BF)
    dh = torch.zeros(b, steps, hsz, dtype=BF)
    before = lr.BACKWARD_STATS.launches
    dgates = lr.lstm_stack_backward_kernel(dh, w[3:], w[:3], act, c)
    assert dgates.shape == act.shape and dgates.dtype == BF
    assert lr.BACKWARD_STATS.launches == before + 1
    plan = lr.lstm_stack_backward_plan(b, hsz, 3)
    (query, qargs), (launch, largs) = lib.calls
    assert query == "qvc_lstm_stack_backward_max_clusters"
    assert qargs == (b, steps, hsz, plan.layer.chunk, 3) and plan.clusters == 9
    assert launch == "qvc_lstm_stack_backward_bf16"
    assert largs[8:13] == (b, steps, hsz, plan.layer.chunk, 3)
    assert largs[0] == dh.data_ptr() and largs[3:6] == (act.data_ptr(), c.data_ptr(),
                                                        dgates.data_ptr())
    assert None not in largs[:8]
    with pytest.raises(RuntimeError, match="take 24 clusters .* the card holds 16"):
        lr.lstm_stack_backward_kernel(torch.zeros(128, steps, hsz, dtype=BF), w[3:], w[:3],
                                      torch.zeros(3, 128, steps, 4 * hsz, dtype=BF),
                                      torch.zeros(3, 128, steps, hsz, dtype=BF))
    assert lr.BACKWARD_STATS.launches == before + 1
    assert lib.calls[-1][0] == "qvc_lstm_stack_backward_max_clusters"
    with pytest.raises(ValueError, match="3 layers take 2 W_ih"):
        lr.lstm_stack_backward_kernel(dh, w[3:4], w[:3], act, c)
    with pytest.raises(ValueError, match="shapes do not match"):
        lr.lstm_stack_backward_kernel(dh[:, :, :32], w[3:], w[:3], act, c)


def test_stack_autograd_takes_one_backward_and_swaps_with_the_step_gate(monkeypatch):
    """``LSTMStack``'s backward goes through the stack backward once (the
    plain one for CPU tensors: the kernel entry is never called), and the
    step gate's ``--card-lstm recurrence`` swaps that entry for its plain
    version while it runs."""
    from quickvc_tpu_torch.scripts.bf16_step_gate import card_lstm

    calls = []
    plain = lr.lstm_stack_backward_reference

    def spy(*args):
        calls.append(len(args[2]))
        return plain(*args)

    monkeypatch.setattr(lr, "lstm_stack_backward_reference", spy)
    monkeypatch.setattr(lr, "lstm_stack_backward_kernel",
                        lambda *a: pytest.fail("the kernel entry on CPU tensors"))
    dh, w_ih, w_hh, act, c = _inputs(3, 16, 3, 1)
    rng = np.random.default_rng(2)
    xp = torch.from_numpy(bf16_round(rng.standard_normal((3, 9, 64)))).to(BF).requires_grad_()
    weights = [torch.from_numpy(w).to(BF).requires_grad_() for w in (*w_hh, *w_ih)]
    bias = [torch.zeros(64, dtype=BF, requires_grad=True) for _ in range(2)]
    out = lr.lstm_stack(xp, weights[3:], bias, weights[:3])
    out.float().sum().backward()
    assert calls == [3] and xp.grad is not None and all(w.grad is not None for w in weights)
    kernel = lr.lstm_stack_backward_kernel
    with card_lstm("recurrence"):
        assert lr.lstm_stack_backward_kernel is lr.lstm_stack_backward_reference
    assert lr.lstm_stack_backward_kernel is kernel


@pytest.mark.parametrize("layers", [1, 3])
def test_plain_stack_backward_at_float64_is_the_exact_gradient(layers):
    """The plain stack backward in float64, the card check's witness for
    the kernel's accuracy, rounds nothing to float32: on a float64 stack's
    act and c it is the gradient autograd takes of the float64 forward,
    every layer's xp gradient, to float64 precision."""
    g = torch.Generator().manual_seed(7 + layers)
    b, t, h = 3, 6, 8
    dt = torch.float64
    xp0 = torch.randn(b, t, 4 * h, generator=g, dtype=dt)
    w_hh = [torch.randn(4 * h, h, generator=g, dtype=dt) / h ** 0.5 for _ in range(layers)]
    w_ih = [torch.randn(4 * h, h, generator=g, dtype=dt) / h ** 0.5 for _ in range(layers - 1)]
    bias = [torch.randn(4 * h, generator=g, dtype=dt) for _ in range(layers - 1)]
    dh = torch.randn(b, t, h, generator=g, dtype=dt)
    xps = [xp0.clone().requires_grad_()]
    for layer in range(layers):
        out = lr.lstm_forward_reference(xps[-1], w_hh[layer])[0]
        if layer + 1 < layers:
            xps.append((out @ w_ih[layer].T + bias[layer]).detach().requires_grad_())
    _, act, c = lr.lstm_stack_reference(xp0, w_ih, bias, w_hh)
    dgates = lr.lstm_stack_backward_reference(dh, w_ih, w_hh, act, c)
    assert dgates.dtype == dt
    # each layer's xp gradient by autograd, top down, on its own graph
    dz = dh
    for layer in reversed(range(layers)):
        xp = xps[layer]
        out = lr.lstm_forward_reference(xp, w_hh[layer])[0]
        (want,) = torch.autograd.grad(out, xp, dz)
        torch.testing.assert_close(dgates[layer], want, rtol=1e-12, atol=1e-12)
        if layer:
            dz = dgates[layer] @ w_ih[layer - 1]
