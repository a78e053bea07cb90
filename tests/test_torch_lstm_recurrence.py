"""PyTorch port, the speaker LSTM's bf16 recurrence (``ops/lstm_recurrence.py``,
``csrc/lstm_recurrence.cu``) on the CPU: the plain forward and backward
that the CPU runs in place of the two kernels, against the step-by-step
loop the port ran before, against the JAX LSTM (its wavefront schedule)
and its gradient at bf16; the plain stack and ``LSTMStack`` against the
per-layer chain, bit for bit; the kernels' partitions; and numpy models of
the two kernels, CTA by CTA from the plan (the forward's layers as a
wavefront over the hand-over counters), against the plain versions bit
for bit.

Tolerances (``PERF.md`` section 2, bf16): outputs ``max|port - jax| <=
max(2 max|jax - jax_f32|, 1e-2 peak)``; gradients ``rel(port, jax) <=
max(2 rel(jax, jax_f32), 2e-2)``, ``rel`` the L2 norm of the difference
over the reference's. The JAX LSTM and its gradient run once for the
module (``jax_runs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_support import bf16_values

from quickvc_tpu_torch.ops import lstm_recurrence as lr
from quickvc_tpu_torch.ops._cuda import require_dtype
from quickvc_tpu_torch.utils import bf16

B, T, C, H, LAYERS = 3, 17, 8, 16, 3
BF = torch.bfloat16


def bf16_round(x) -> np.ndarray:
    return bf16_values(bf16.to_bits(np.asarray(x, np.float32)))


def rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def params(seed: int = 0, scale: float = 0.4) -> list[tuple[np.ndarray, ...]]:
    """(w_ih, w_hh, b_ih, b_hh) of each layer, float32, torch's layout."""
    rng = np.random.default_rng(seed)
    return [tuple((scale * rng.standard_normal(s)).astype(np.float32)
                  for s in ((4 * H, C if layer == 0 else H), (4 * H, H), (4 * H,), (4 * H,)))
            for layer in range(LAYERS)]


def mel(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T, C)).astype(np.float32)


def step_loop(x: torch.Tensor, layers) -> torch.Tensor:
    """The speaker LSTM's bf16 recurrence as the port ran it before the
    kernels (``models/encoders.py``'s ``_recurrence``): the output sequence
    of the last layer."""
    for w_ih, w, b in layers:
        xp = x @ w_ih.T + b
        w = w.T
        h = c = x.new_zeros(x.shape[0], w.shape[0])
        hs = []
        for t in range(x.shape[1]):
            i, f, g, o = (xp[:, t] + h @ w).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        x = torch.stack(hs, dim=1)
    return x


def ours(x: torch.Tensor, layers) -> torch.Tensor:
    """The per-layer chain: each layer's projection, then its recurrence."""
    for w_ih, w, b in layers:
        x = lr.lstm_recurrence(x @ w_ih.T + b, w)
    return x


def stack(x: torch.Tensor, layers) -> torch.Tensor:
    """The speaker encoder's path: layer 0's projection, then ``LSTMStack``."""
    w_ih, w_hh, b = zip(*layers)
    return lr.lstm_stack(x @ w_ih[0].T + b[0], w_ih[1:], b[1:], w_hh)


PATHS = {"chain": ours, "stack": stack}


def torch_run(fn, p, x, dtype=BF, weigh=None):
    """fn's last-layer sequence from float32 parameters cast to dtype (the
    biases summed in float32, as the speaker encoder casts them), and with
    ``weigh`` the gradients of sum(out * weigh) for every parameter and x."""
    leaves = [[torch.from_numpy(a).requires_grad_(weigh is not None) for a in layer]
              for layer in p]
    xt = torch.from_numpy(x).requires_grad_(weigh is not None)
    layers = [(w_ih.to(dtype), w_hh.to(dtype), (b_ih + b_hh).to(dtype))
              for w_ih, w_hh, b_ih, b_hh in leaves]
    out = fn(xt.to(dtype), layers)
    if weigh is None:
        return out
    (out.float() * torch.from_numpy(weigh)).sum().backward()
    return out, [a.grad.numpy() for layer in leaves for a in layer] + [xt.grad.numpy()]


def test_plain_forward_equals_the_step_loop():
    p, x = params(), mel()
    with torch.no_grad():
        assert torch.equal(torch_run(ours, p, x), torch_run(step_loop, p, x))
    # and the speaker encoder's bf16 path runs it on the CPU, launching nothing
    from quickvc_tpu_torch.models.encoders import SpeakerEncoder

    enc = SpeakerEncoder(C, LAYERS, H, 8)
    with torch.no_grad():
        for layer, (w_ih, w_hh, b_ih, b_hh) in enumerate(p):
            for name, a in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                               (w_ih, w_hh, b_ih, b_hh)):
                getattr(enc.lstm, f"{name}_l{layer}").copy_(torch.from_numpy(a))
        before = (lr.STATS.launches, lr.BACKWARD_STATS.launches)
        assert torch.equal(enc._recurrence(torch.from_numpy(x).to(BF)),
                           torch_run(step_loop, p, x)[:, -1])
        assert (lr.STATS.launches, lr.BACKWARD_STATS.launches) == before


def _jax_lstm(p, x, dtype):
    from quickvc_tpu.models.encoders import LSTM

    tree = {f"{k}_l{layer}": jnp.asarray(a) for layer, ps in enumerate(p)
            for k, a in zip(("w_ih", "w_hh", "b_ih", "b_hh"), ps)}
    model = LSTM(hidden_size=H, num_layers=LAYERS)
    return lambda tr, xx: model.apply({"params": tr}, xx.astype(dtype)), tree


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX LSTM (its wavefront schedule, exact against the sequential
    one) at bf16 and float32 on the bf16 mel: the last h, and jax.grad of
    sum(h * weigh) for every parameter and the mel; once for the module."""
    p, x = params(), mel()
    weigh = np.random.default_rng(3).standard_normal((B, H)).astype(np.float32)
    outs, grads = {}, {}
    for dt in (jnp.bfloat16, jnp.float32):
        fn, tree = _jax_lstm(p, x, dt)

        # one compile gives both: the gradient of sum(h * weigh) is the vjp of weigh
        @jax.jit
        def run(tr, xx, fn=fn):
            out, vjp = jax.vjp(lambda a, b: fn(a, b).astype(jnp.float32), tr, xx)
            return out, vjp(jnp.asarray(weigh))

        out, (g_tree, g_x) = run(tree, jnp.asarray(x))
        outs[dt] = np.asarray(out)
        grads[dt] = [np.asarray(g_tree[f"{k}_l{layer}"], np.float32) for layer in range(LAYERS)
                     for k in ("w_ih", "w_hh", "b_ih", "b_hh")] + [np.asarray(g_x, np.float32)]
    return {"outs": outs, "grads": grads, "weigh": weigh}


@pytest.mark.parametrize("path", PATHS)
def test_plain_forward_matches_jax_lstm(jax_runs, path):
    """The JAX LSTM on the bf16 mel against the port's last h, through the
    per-layer chain and through the plain stack."""
    p, x = params(), mel()
    with torch.no_grad():
        port = torch_run(PATHS[path], p, x)[:, -1].float().numpy()
    ref, ref32 = jax_runs["outs"][jnp.bfloat16], jax_runs["outs"][jnp.float32]
    bound = max(2 * np.abs(ref - ref32).max(), 1e-2 * np.abs(ref32).max())
    assert np.abs(port - ref).max() <= bound


def test_plain_backward_matches_autograd_of_the_step_loop():
    """Every gradient bit-equal to autograd's of the loop but W_hh's, which
    autograd sums step by step in bf16 and the Function sums in float32 once;
    that one by the bf16 gradient rule, the loop in float32 the yardstick."""
    p, x = params(), mel()
    weigh = np.random.default_rng(2).standard_normal((B, T, H)).astype(np.float32)
    _, g_ours = torch_run(ours, p, x, weigh=weigh)
    _, g_loop = torch_run(step_loop, p, x, weigh=weigh)
    _, g_32 = torch_run(step_loop, p, x, torch.float32, weigh)
    names = [f"{k}_l{layer}" for layer in range(LAYERS) for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    for name, a, b, r in zip(names + ["x"], g_ours, g_loop, g_32):
        if name.startswith("w_hh"):
            assert rel(a, b) <= max(2 * rel(b, r), 2e-2), name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_stack_equals_the_per_layer_chain():
    """``LSTMStack`` on the CPU (the plain stack forward, its backward layer
    by layer with the projections' gradients as autograd computes them):
    the output sequence and every gradient bit-equal to the per-layer
    chain's, and the stack's saved h, act and c equal to each layer's."""
    p, x = params(), mel()
    weigh = np.random.default_rng(4).standard_normal((B, T, H)).astype(np.float32)
    out_s, g_s = torch_run(stack, p, x, weigh=weigh)
    out_c, g_c = torch_run(ours, p, x, weigh=weigh)
    assert torch.equal(out_s, out_c)
    for i, (a, b) in enumerate(zip(g_s, g_c)):
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    layers = [(torch.from_numpy(w_ih).to(BF), torch.from_numpy(w_hh).to(BF),
               (torch.from_numpy(b_ih) + torch.from_numpy(b_hh)).to(BF))
              for w_ih, w_hh, b_ih, b_hh in p]
    with torch.no_grad():
        xp = torch.from_numpy(x).to(BF) @ layers[0][0].T + layers[0][2]
        h, act, c = lr.lstm_stack_reference(xp, [z[0] for z in layers[1:]],
                                            [z[2] for z in layers[1:]], [z[1] for z in layers])
        for layer, (w_ih, w_hh, b) in enumerate(layers):
            want = lr.lstm_forward_reference(xp, w_hh)
            assert all(torch.equal(a, z) for a, z in zip((h[layer], act[layer], c[layer]), want))
            if layer + 1 < LAYERS:
                xp = want[0] @ layers[layer + 1][0].T + layers[layer + 1][2]


@pytest.mark.parametrize("path", PATHS)
def test_plain_backward_matches_jax_grad(jax_runs, path):
    """jax.grad of the JAX LSTM at bf16 (its scan's transpose) against the
    port's gradients, through the chain and through ``LSTMStack``: every
    weight, bias and the mel."""
    p, x = params(), mel()
    _, port = torch_run(lambda xx, ls: PATHS[path](xx, ls)[:, -1], p, x,
                        weigh=jax_runs["weigh"])
    grads = jax_runs["grads"]
    for i, (a, r, r32) in enumerate(zip(port, grads[jnp.bfloat16], grads[jnp.float32])):
        assert rel(a, r) <= max(2 * rel(r, r32), 2e-2), i


@pytest.mark.parametrize("batch,hidden", [(32, 256), (2, 16), (64, 256), (33, 48), (1, 16),
                                          (96, 128)])
def test_plan_covers_each_unit_once(batch, hidden):
    plan = lr.lstm_plan(batch, hidden)
    assert plan.cluster == lr.CLUSTER and plan.units * plan.cluster == hidden
    assert plan.units % 2 == 0 and plan.chunk <= lr.MAX_CHUNK
    seen = np.zeros((batch, hidden), int)
    for rows, units in plan.slices(batch):
        assert len(rows) >= 1
        seen[np.ix_(list(rows), list(units))] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch,hidden,sms,match", [
    (32, 8, 132, "multiple of 16"), (32, 24, 132, "multiple of 16"),
    (32, 272, 132, r"\[16, 256\]"), (0, 64, 132, "at least 1"),
    (32 * 17, 256, 132, "more than the card's 132 SMs")])
def test_plan_refuses_what_it_does_not_take(batch, hidden, sms, match):
    with pytest.raises(ValueError, match=match):
        lr.lstm_plan(batch, hidden, sms)


@pytest.mark.parametrize("batch,hidden,layers", [(32, 256, 3), (37, 32, 3), (2, 16, 1),
                                                 (640, 64, 3)])
def test_stack_plan_covers_each_layer_unit_once(batch, hidden, layers):
    """L x ceil(B / 32) clusters, layer by layer in launch order, each a
    layer's (rows, units) cut as lstm_plan cuts it; 640 rows take 60
    clusters, which the plan leaves to the card's residency check."""
    plan = lr.lstm_stack_plan(batch, hidden, layers)
    assert plan.layers == layers and plan.skew == lr.SKEW >= 2
    assert plan.clusters == layers * plan.layer.clusters
    assert plan.serial_steps(512) == 512 + (layers - 1) * lr.SKEW
    seen = np.zeros((layers, batch, hidden), int)
    for layer in range(layers):
        for rows, units in plan.layer.slices(batch):
            seen[layer][np.ix_(list(rows), list(units))] += 1
    assert (seen == 1).all()
    with pytest.raises(ValueError, match="1 to 4 layers"):
        lr.lstm_stack_plan(batch, hidden, lr.MAX_LAYERS + 1)


def _sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(np.float32)


def stack_model(xp0: np.ndarray, w_ih, b, w_hh, plan: lr.StackPlan):
    """The forward kernel in numpy, cluster by cluster and CTA by CTA from
    the plan, on the wavefront schedule: iteration k runs layer l at step
    k - l skew. A cluster of layer l >= 1 may load step t's h of the layer
    below (from its output, as the kernel does) only once that layer's
    counter says step t is published; it loads skew - 1 steps ahead, so at
    step t it needs step t + skew - 1. CTA j takes the 4U gate columns of
    its units (column 4u + q: gate q of unit u), their rows of W_hh (and of
    W_ih), and every step h_{t-1} of the whole chunk from its own buffer,
    which every CTA fills with its units' new h; each product a float32 sum
    rounded once (the projection's then plus the bias and rounded), then
    the cell in the kernel's roundings. Each (layer, row, step, unit) is
    written exactly once."""
    b_sz, t, g4 = xp0.shape
    hsz, u, layers = g4 // 4, plan.layer.units, plan.layers
    h_out, c_out = (np.full((layers, b_sz, t, hsz), np.nan, np.float32) for _ in range(2))
    act = np.full((layers, b_sz, t, g4), np.nan, np.float32)
    chunks = plan.layer.clusters
    count = np.zeros((layers, chunks), int)
    state = {}
    for k in range(plan.serial_steps(t)):
        done = []
        for layer in range(layers):
            s = k - layer * plan.skew
            if not 0 <= s < t:
                continue
            for kc in range(chunks):
                rows = slice(kc * plan.layer.chunk, min((kc + 1) * plan.layer.chunk, b_sz))
                n = rows.stop - rows.start
                if layer:
                    assert count[layer - 1, kc] >= min(s + plan.skew, t), (layer, kc, s)
                    x = h_out[layer - 1, rows, s]
                    assert not np.isnan(x).any()
                h_buf, c = state.get((layer, kc), (np.zeros((n, hsz), np.float32),
                                                   np.zeros((plan.layer.cluster, n, u),
                                                            np.float32)))
                new_h = np.full((n, hsz), np.nan, np.float32)
                for j in range(plan.layer.cluster):
                    u0 = j * u
                    cols = [q * hsz + u0 + up for up in range(u) for q in range(4)]
                    acc = (h_buf.astype(np.float64) @ w_hh[layer][cols].T.astype(np.float64)
                           ).astype(np.float32).reshape(n, u, 4)
                    if layer:
                        xw = (x.astype(np.float64) @ w_ih[layer - 1][cols].T.astype(np.float64)
                              ).astype(np.float32).reshape(n, u, 4)
                        xb = b[layer - 1][cols].reshape(u, 4)
                        xq = [bf16_round(bf16_round(xw[:, :, q]) + xb[:, q]) for q in range(4)]
                    else:
                        xq = [xp0[rows, s, q * hsz + u0: q * hsz + u0 + u] for q in range(4)]
                    gate = [bf16_round(xq[q] + bf16_round(acc[:, :, q])) for q in range(4)]
                    si, sf = bf16_round(_sigmoid(gate[0])), bf16_round(_sigmoid(gate[1]))
                    tg, so = bf16_round(np.tanh(gate[2])), bf16_round(_sigmoid(gate[3]))
                    c[j] = bf16_round(bf16_round(sf * c[j]) + bf16_round(si * tg))
                    h = bf16_round(so * bf16_round(np.tanh(c[j])))
                    for arr, val, off in ((h_out, h, 0), (c_out, c[j], 0), (act, si, 0),
                                          (act, sf, hsz), (act, tg, 2 * hsz),
                                          (act, so, 3 * hsz)):
                        assert np.isnan(arr[layer, rows, s, off + u0: off + u0 + u]).all()
                        arr[layer, rows, s, off + u0: off + u0 + u] = val
                    assert np.isnan(new_h[:, u0: u0 + u]).all()
                    new_h[:, u0: u0 + u] = h
                assert not np.isnan(new_h).any()
                state[(layer, kc)] = (new_h, c)
                done.append((layer, kc, s + 1))
        for layer, kc, published in done:   # after the cluster barrier that ends the step
            count[layer, kc] = published
    assert (count == t).all()
    return h_out, act, c_out


def backward_model(dh_out, w_hh, act, c, plan: lr.LSTMPlan) -> np.ndarray:
    """The backward kernel in numpy, CTA by CTA: every step CTA j takes
    dgates_{t+1} of the whole chunk from its own buffer (columns grouped by
    CTA: 4U jj + 4 u' + q), multiplies it by W_hh's columns of its units
    (rows permuted to that order; a float32 sum rounded once), runs the
    cell's gradient with dc carried, and writes its units' four gate
    gradients to dgates and to every CTA's buffer, each exactly once."""
    b, t, hsz = c.shape
    u = plan.units
    dgates = np.full((b, t, 4 * hsz), np.nan, np.float32)
    order = [q * hsz + jj * u + up for jj in range(plan.cluster) for up in range(u)
             for q in range(4)]
    for k in range(plan.clusters):
        rows = slice(k * plan.chunk, min((k + 1) * plan.chunk, b))
        n = rows.stop - rows.start
        g_buf = None
        dc_next = np.zeros((plan.cluster, n, u), np.float32)
        for s in reversed(range(t)):
            new_g = np.full((n, 4 * hsz), np.nan, np.float32)
            for j in range(plan.cluster):
                us = slice(j * u, (j + 1) * u)
                dh = dh_out[rows, s, us]
                if g_buf is not None:
                    rec = (g_buf.astype(np.float64) @ w_hh[order][:, us].astype(np.float64))
                    dh = bf16_round(dh + bf16_round(rec.astype(np.float32)))
                si, sf, tg, so = (act[rows, s, q * hsz + j * u: q * hsz + (j + 1) * u]
                                  for q in range(4))
                c_prev = c[rows, s - 1, us] if s else np.zeros((n, u), np.float32)
                tc = bf16_round(np.tanh(c[rows, s, us]))
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
                    assert np.isnan(dgates[rows, s, at]).all()
                    dgates[rows, s, at] = gq
                    local = [4 * u * j + 4 * up + q for up in range(u)]
                    assert np.isnan(new_g[:, local]).all()
                    new_g[:, local] = gq
            assert not np.isnan(new_g).any()
            g_buf = new_g
    return dgates


def _model_inputs(batch: int, hidden: int, layers: int, seed: int):
    rng = np.random.default_rng(seed)
    xp = bf16_round(rng.standard_normal((batch, 9, 4 * hidden)))
    w_hh = [bf16_round(0.4 * rng.standard_normal((4 * hidden, hidden))) for _ in range(layers)]
    w_ih = [bf16_round(0.4 * rng.standard_normal((4 * hidden, hidden)))
            for _ in range(layers - 1)]
    b = [bf16_round(0.2 * rng.standard_normal(4 * hidden)) for _ in range(layers - 1)]
    return xp, w_ih, b, w_hh


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(a).to(BF)


@pytest.mark.parametrize("batch,hidden", [(B, H), (37, 32)])
def test_kernel_models_match_the_plain_versions(batch, hidden):
    """One layer, the forward kernel as a stack of one, and the backward:
    (3, 16): one cluster, two units a CTA; (37, 32): two clusters of 19
    and 18 rows, four units a CTA. Forward and backward, bit for bit."""
    xp, _, _, (w_hh,) = _model_inputs(batch, hidden, 1, hidden)
    dh = bf16_round(np.random.default_rng(hidden + 1).standard_normal((batch, 9, hidden)))
    model = [z[0] for z in stack_model(xp, [], [], [w_hh], lr.lstm_stack_plan(batch, hidden, 1))]
    with torch.no_grad():
        plain = lr.lstm_forward_reference(_bf(xp), _bf(w_hh))
    for m, p in zip(model, plain):
        np.testing.assert_array_equal(m, p.float().numpy())
    back = backward_model(dh, w_hh, *model[1:], lr.lstm_plan(batch, hidden))
    with torch.no_grad():
        want = lr.lstm_backward_reference(_bf(dh), _bf(w_hh), plain[1], plain[2])
    np.testing.assert_array_equal(back, want.float().numpy())


@pytest.mark.parametrize("batch,hidden", [(B, H), (37, 32)])
def test_stack_model_matches_the_plain_stack(batch, hidden):
    """Three layers on the wavefront, the hand-over counters honoured: h,
    act and c of every layer bit-equal to the plain stack (the per-layer
    plain versions chained through ``h @ w_ih.T + b``)."""
    xp, w_ih, b, w_hh = _model_inputs(batch, hidden, LAYERS, 3 * hidden)
    model = stack_model(xp, w_ih, b, w_hh, lr.lstm_stack_plan(batch, hidden, LAYERS))
    with torch.no_grad():
        plain = lr.lstm_stack_reference(_bf(xp), [_bf(w) for w in w_ih], [_bf(z) for z in b],
                                        [_bf(w) for w in w_hh])
    for m, p in zip(model, plain):
        np.testing.assert_array_equal(m, p.float().numpy())


class FakeLib:
    """The kernel library, recording each call; the card holds ``held``
    clusters of the stack kernel at once."""

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


def test_wrappers_hand_the_kernels_their_plan(monkeypatch):
    """The two per-layer wrappers launch their entries with the shapes and
    the plan's chunk (read back through a fake library), each as a stack of
    one (no residency query), count each launch, and refuse float32 and a
    W_hh of another width."""
    lib = _fake(monkeypatch)
    xp = torch.zeros(40, 5, 4 * 64, dtype=BF)
    w = torch.zeros(4 * 64, 64, dtype=BF)
    before = (lr.STATS.launches, lr.BACKWARD_STATS.launches)
    h, act, c = lr.lstm_forward_kernel(xp, w)
    assert (h.shape, act.shape, c.shape) == ((40, 5, 64), (40, 5, 256), (40, 5, 64))
    dgates = lr.lstm_backward_kernel(h, w, act, c)
    assert dgates.shape == xp.shape and dgates.dtype == BF
    assert (lr.STATS.launches, lr.BACKWARD_STATS.launches) == (before[0] + 1, before[1] + 1)
    (fwd, fargs), (bwd, bargs) = lib.calls
    assert fwd == "qvc_lstm_stack_bf16" and fargs[8:14] == (40, 5, 64, 20, 1, lr.SKEW)
    assert fargs[:2] == (xp.data_ptr(), None) and fargs[2] is None
    # the backward as a stack of one: 16-row chunks, no W_ih, scratch or counters
    assert bwd == "qvc_lstm_stack_backward_bf16" and bargs[8:13] == (40, 5, 64, 14, 1)
    assert bargs[3:6] == (act.data_ptr(), c.data_ptr(), dgates.data_ptr())
    assert bargs[1] is None and bargs[6] is None and bargs[7] is None
    with pytest.raises(TypeError, match="bfloat16"):
        lr.lstm_forward_kernel(xp.float(), w.float())
    with pytest.raises(ValueError, match="does not match"):
        lr.lstm_forward_kernel(xp, w[:, :32])


def test_stack_wrapper_hands_the_kernel_its_plan(monkeypatch):
    """Three layers: the wrapper asks the card how many of the plan's
    clusters it holds at once (the stack's sizes, chunk and skew), launches
    the stack entry once with every layer's weights stacked, zeroed
    counters and outputs for every layer, and counts one launch; it raises
    RuntimeError naming both numbers, and launches nothing, when the card
    holds fewer clusters than the plan needs."""
    lib = _fake(monkeypatch, held=16)
    hsz = 64
    xp = torch.zeros(40, 5, 4 * hsz, dtype=BF)
    w = [torch.full((4 * hsz, hsz), float(i), dtype=BF) for i in range(5)]
    bias = [torch.zeros(4 * hsz, dtype=BF) for _ in range(2)]
    before = lr.STATS.launches
    h, act, c = lr.lstm_stack_kernel(xp, w[3:], bias, w[:3])
    assert (h.shape, act.shape, c.shape) == ((3, 40, 5, hsz), (3, 40, 5, 4 * hsz),
                                             (3, 40, 5, hsz))
    assert lr.STATS.launches == before + 1
    plan = lr.lstm_stack_plan(40, hsz, 3)
    (query, qargs), (launch, largs) = lib.calls
    assert query == "qvc_lstm_stack_max_clusters"
    assert qargs == (40, 5, hsz, plan.layer.chunk, 3, plan.skew) and plan.clusters == 6
    assert launch == "qvc_lstm_stack_bf16"
    assert largs[8:14] == (40, 5, hsz, plan.layer.chunk, 3, plan.skew)
    assert largs[4:7] == (h.data_ptr(), act.data_ptr(), c.data_ptr())
    with pytest.raises(RuntimeError, match="take 60 clusters .* the card holds 16"):
        lr.lstm_stack_kernel(torch.zeros(640, 5, 4 * hsz, dtype=BF), w[3:], bias, w[:3])
    assert lr.STATS.launches == before + 1 and lib.calls[-1][0] == "qvc_lstm_stack_max_clusters"
    with pytest.raises(ValueError, match="3 layers take 2"):
        lr.lstm_stack_kernel(xp, w[3:4], bias, w[:3])
