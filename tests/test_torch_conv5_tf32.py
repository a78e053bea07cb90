"""PyTorch port, the arithmetic of K5 (k=5 conv + bias + LeakyReLU, and its
dx) and K6 (its dW), ``csrc/fused_disc_conv.cu``, emulated in numpy, and
K6's host plan (``ops/fused_disc_conv.py:dw_plan``).

The emulation follows the kernel: A gathered from x with the row shift and
the SAME padding as zeros, every product in 3xTF32 one 8-wide k chunk at a
time, the chunk's three products summed from zero and then added to the
float32 accumulator (``torch_port_support.mma`` with ``promote``, as
``csrc/tf32x3.cuh:mma_3xtf32_promoted`` computes), k walked in order from 0
(K5: k = (dr, c); K6: k = (n, r)); K6's reduction cut as ``dw_plan`` cuts
it, one float32 partial a split, the partials summed in split order. Held
against float64 convolutions at small widths with long reductions. A model
of the tensor core's truncating in-mma sum shows why the products are not
chained into the accumulator.

Tolerance: the kernels' gate, atol 1e-4 / rtol 1e-3. Single-pass TF32 is
shown to land well above 3xTF32's error (a ratio, not a threshold). No JAX,
no card.
"""

import numpy as np
import pytest
import torch
from torch_port_support import mma

from quickvc_tpu_torch.ops import fused_disc_conv as fdc


def gather(x: np.ndarray) -> np.ndarray:
    """K5's A, (N*R, 5*C_in): A[(n, r), (dr, c)] = x[n, r + dr - 2, c], zero outside."""
    n, rows, c = x.shape
    xp = np.pad(x, ((0, 0), (2, 2), (0, 0)))
    return np.concatenate([xp[:, dr:dr + rows] for dr in range(5)], axis=-1).reshape(n * rows,
                                                                                     5 * c)


def k5_body(x, w, b, slope: float, passes: int = 3) -> np.ndarray:
    """K5 over x (N, R, C_in), w (5, C_in, C_out), b (C_out) or None."""
    n, rows, _ = x.shape
    c_out = w.shape[2]
    acc = mma(np.zeros((n * rows, c_out), np.float32), gather(x), w.reshape(-1, c_out), passes,
              promote=True)
    v = acc if b is None else (acc + b).astype(np.float32)
    return np.where(v > 0, v, np.float32(slope) * v).reshape(n, rows, c_out)


def k6_body(x, dym, passes: int = 3) -> np.ndarray:
    """K6 over x (N, R, C_in), dym (N, R, C_out), split as dw_plan splits it."""
    n, rows, c_in = x.shape
    c_out = dym.shape[2]
    plan = fdc.dw_plan(n, rows, c_in, c_out)
    a, bm = gather(x).T, dym.reshape(n * rows, c_out)
    parts = [mma(np.zeros((5 * c_in, c_out), np.float32), a[:, lo:lo + plan.k_chunk],
                 bm[lo:lo + plan.k_chunk], passes, promote=True)
             for lo in range(0, n * rows, plan.k_chunk)]
    assert len(parts) == plan.splits
    out = parts[0]
    for p in parts[1:]:
        out = (out + p).astype(np.float32)
    return out.reshape(5, c_in, c_out)


def conv64(x, w, b, slope: float) -> np.ndarray:
    rows = x.shape[1]
    xp = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (0, 0)))
    v = sum(xp[:, dr:dr + rows] @ w[dr].astype(np.float64) for dr in range(5))
    if b is not None:
        v = v + b
    return np.where(v > 0, v, slope * v)


def dw64(x, dym) -> np.ndarray:
    rows = x.shape[1]
    xp = np.pad(x.astype(np.float64), ((0, 0), (2, 2), (0, 0)))
    return np.stack([np.einsum("nrc,nro->co", xp[:, dr:dr + rows], dym.astype(np.float64))
                     for dr in range(5)])


def within_gate(ours, ref) -> bool:
    return bool(np.all(np.abs(ours - ref) <= 1e-4 + 1e-3 * np.abs(ref)))


def conv_inputs(rng, n, rows, c_in, c_out):
    """O(1) outputs: filter scaled by 1/sqrt(5 C_in), dym by 1/sqrt(N R)."""
    x = rng.standard_normal((n, rows, c_in)).astype(np.float32)
    w = (rng.standard_normal((5, c_in, c_out)) / np.sqrt(5 * c_in)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c_out)).astype(np.float32)
    dym = (rng.standard_normal((n, rows, c_out)) / np.sqrt(n * rows)).astype(np.float32)
    return x, w, b, dym


@pytest.mark.parametrize("shape", [(4, 37, 96, 40), (8, 12, 256, 64)])
def test_k5_body_matches_float64_conv(rng, shape):
    """Forward (bias, slope 0.1) and dx (the flipped, transposed filter,
    slope 1) over reductions of 480 and 1,280; R = 12 is the shortest
    period's row count, where the SAME padding and item edges are a third
    of the rows."""
    x, w, b, dym = conv_inputs(rng, *shape)
    y = k5_body(x, w, b, 0.1)
    assert y.shape == shape[:2] + (shape[3],) and np.isfinite(y).all()
    assert within_gate(y, conv64(x, w, b, 0.1))
    w_flip = np.ascontiguousarray(w[::-1].transpose(0, 2, 1))
    dx = k5_body(dym * np.sqrt(shape[0] * shape[1]), w_flip, None, 1.0)
    assert within_gate(dx, conv64(dym * np.sqrt(shape[0] * shape[1]), w_flip, None, 1.0))


@pytest.mark.parametrize("shape", [(64, 37, 24, 40), (176, 12, 16, 24)])
def test_k6_body_matches_float64_dw(rng, shape):
    """N*R = 2,368 and 2,112: four splits of the reduction each."""
    x, _, _, dym = conv_inputs(rng, *shape)
    assert fdc.dw_plan(*shape).splits == 4
    dw = k6_body(x, dym)
    assert dw.shape == (5, shape[2], shape[3])
    assert within_gate(dw, dw64(x, dym))


def test_single_pass_tf32_is_far_less_accurate(rng):
    x, w, b, dym = conv_inputs(rng, 4, 37, 96, 40)
    ref_y, ref_dw = conv64(x, w, b, 0.1), dw64(x, dym)
    err3 = max(np.abs(k5_body(x, w, b, 0.1) - ref_y).max(), np.abs(k6_body(x, dym) - ref_dw).max())
    err1 = max(np.abs(k5_body(x, w, b, 0.1, passes=1) - ref_y).max(),
               np.abs(k6_body(x, dym, passes=1) - ref_dw).max())
    assert err1 > 30 * err3


def test_promoted_sum_bounds_the_truncation(rng):
    """With the in-mma sums truncating (round toward zero, a model of the
    tensor core's adder), chaining every product into the accumulator errs
    by far more than summing each k8 step's three products apart."""
    x, w, _, _ = conv_inputs(rng, 8, 12, 256, 64)
    a, wm = gather(x), w.reshape(-1, 64)
    ref = conv64(x, w, None, 1.0).reshape(96, 64)
    zero = np.zeros((96, 64), np.float32)
    chained = np.abs(mma(zero, a, wm, 3, rz=True) - ref).max()
    promoted = mma(zero, a, wm, 3, promote=True, rz=True)
    assert within_gate(promoted, ref)
    assert chained > 10 * np.abs(promoted - ref).max()


PERIOD_SHAPES = list(fdc.disc_conv5_shapes(64, 10240).values())
RAGGED = [(3, 37, 24, 40), (1, 1, 1, 1), (5, 13, 30, 42), (64, 37, 24, 40), (2, 3, 1000, 7),
          (1000, 7, 8, 8), (33, 100, 512, 512), (11, 12, 1024, 1024), (4096, 1, 4, 4)]


@pytest.mark.parametrize("sm_count", [132, 114, 1])
def test_dw_plan_covers_the_reduction_once(sm_count):
    """Every k in [0, N*R) in exactly one split, no split empty, split edges
    on K-tile multiples, the workspace one partial dW a split."""
    for shape in [(n, r, c, c) for n, r, c in PERIOD_SHAPES] + RAGGED:
        n, rows, c_in, c_out = shape
        plan = fdc.dw_plan(n, rows, c_in, c_out, sm_count)
        k = n * rows
        assert 1 <= plan.splits <= fdc.MAX_SPLITS
        assert plan.k_chunk % fdc.K_TILE == 0
        cover = np.zeros(k, np.int64)
        for z in range(plan.splits):
            lo, hi = z * plan.k_chunk, min((z + 1) * plan.k_chunk, k)
            assert lo < hi, (shape, plan)
            cover[lo:hi] += 1
        assert (cover == 1).all(), (shape, plan)
        assert plan.workspace == (plan.splits * 5 * c_in * c_out if plan.splits > 1 else 0)


def test_dw_plan_at_the_period_shapes():
    """160 tiles on 132 slots: four splits fill 97% of the last wave."""
    for n, rows, c in PERIOD_SHAPES:
        plan = fdc.dw_plan(n, rows, c, c)
        assert plan.splits == 4 and plan.workspace == 4 * 5 * c * c


def test_disc_conv5_shapes_match_the_discriminator():
    """The fifth conv's input at each period, read from DiscriminatorP at a
    narrow width on a 10,240-sample wave."""
    from quickvc_tpu_torch.models.discriminators import DiscriminatorP

    for p, (n, rows, c) in fdc.disc_conv5_shapes(2, 10240, channels=32).items():
        net = DiscriminatorP(p, width=1 / 32)
        seen = []
        net.convs[-1].register_forward_hook(lambda m, args, out: seen.append(args[0].shape))
        with torch.no_grad():
            net(torch.zeros(2, 1, 10240))
        b, ch, h, w = seen[0]
        assert (b * w, h, ch) == (n, rows, c)


def test_dw_wrapper_allocates_the_planned_workspace(monkeypatch):
    """The wrapper hands the kernel the plan's split count, k_chunk and a
    workspace of the plan's size (the launch itself faked: no card here)."""
    calls, sizes = [], []
    real_empty = torch.empty

    class FakeLib:
        def qvc_conv5_dw(self, *args):
            calls.append(args)
            return 0

    def spy_empty(*shape, **kw):
        sizes.append(shape)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(fdc, "_require", lambda *a: None)
    monkeypatch.setattr(fdc, "library", lambda: FakeLib())
    monkeypatch.setattr(fdc, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fdc, "device_sms", lambda index: 132)
    monkeypatch.setattr(torch, "empty", spy_empty)
    for n, rows, c_in, c_out in [(64, 37, 24, 40), (3, 37, 24, 40)]:
        calls.clear()
        sizes.clear()
        before = fdc.DW_STATS.launches
        fdc.conv5_dw_kernel(real_empty(n, rows, c_in), real_empty(n, rows, c_out))
        plan = fdc.dw_plan(n, rows, c_in, c_out)
        assert fdc.DW_STATS.launches == before + 1
        *_, splits, k_chunk, _ = calls[0]
        assert (splits, k_chunk) == (plan.splits, plan.k_chunk)
        assert sizes[0] == ((5, c_in, c_out),)
        assert (calls[0][3] is None) == (plan.workspace == 0)
        assert sizes[1:] == ([(plan.workspace,)] if plan.workspace else [])


def test_build_hashes_every_source_and_header():
    """The library's cache key hashes SOURCES + HEADERS only, so every .cu
    under csrc is built and every header a source includes is listed: an
    edited header left out would load a stale library."""
    import re

    from quickvc_tpu_torch.ops import _cuda

    names = {p.name for p in _cuda.CSRC.iterdir()}
    assert set(_cuda.SOURCES) == {n for n in names if n.endswith(".cu")}
    included = {m for n in names if n.endswith((".cu", ".cuh"))
                for m in re.findall(r'#include "([^"]+)"', (_cuda.CSRC / n).read_text())}
    assert included <= set(_cuda.HEADERS) == {n for n in names if n.endswith(".cuh")}
