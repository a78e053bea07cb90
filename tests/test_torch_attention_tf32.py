"""PyTorch port, the arithmetic of the attention body that K2, K8, K9 and K10
share (``csrc/fused_attention.cuh``), emulated in numpy: each float32
operand x split into big, x rounded to TF32 as ``cvt.rna`` rounds (add
0x1000 to the bits, mask with 0xFFFFE000), and small = x - big, which the
tensor core reads to its top 10 mantissa bits (mask only); every product
taken as small*big + big*small, then big*big, one 8-wide k chunk at a time
into a float32 accumulator (as ``mma.sync.m16n8k8`` does), and the online
softmax over the kernel's key tiles (64 keys, 16 at head dim 128) with a
float32 running max and sum in log2 units. Held against float64 softmax
attention.

Tolerance: the kernels' gate, atol 1e-4 / rtol 1e-3. Single-pass TF32 is
shown to land well above 3xTF32's error (a ratio, not a threshold). No JAX,
no card.
"""

import numpy as np
import pytest

LOG2E = np.float32(1.4426950408889634)


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(x: np.ndarray) -> np.ndarray:
    """A float32 operand as the tensor core reads it: the top 10 mantissa bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = tf32(x)
    return big, tf32_read(x.astype(np.float32) - big)


def mma(c: np.ndarray, a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """c + a @ b over 8-wide k chunks, float32 accumulation; 3xTF32 or one TF32 pass."""
    for k0 in range(0, a.shape[-1], 8):
        ac, bc = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if passes == 3:
            (ab, as_), (bb, bs) = split(ac), split(bc)
            terms = (as_, bb), (ab, bs), (ab, bb)
        else:
            terms = ((tf32(ac), tf32(bc)),)
        for x, y in terms:   # products of TF32 values are exact in float64
            c = (c + (x.astype(np.float64) @ y.astype(np.float64)).astype(np.float32))
    return c.astype(np.float32)


def body(q, k, v, scale: float, passes: int = 3) -> np.ndarray:
    """The kernel body's arithmetic over (B, H, T, D) float32 inputs."""
    *lead, t, d = q.shape
    bn = 16 if d == 128 else 64
    sl2 = np.float32(scale) * LOG2E
    m = np.full((*lead, t, 1), -np.inf, np.float32)
    l = np.zeros((*lead, t, 1), np.float32)
    acc = np.zeros((*lead, t, d), np.float32)
    for n0 in range(0, t, bn):
        kt = np.zeros((*lead, bn, d), np.float32)
        vt = np.zeros((*lead, bn, d), np.float32)
        kt[..., : t - n0, :] = k[..., n0:n0 + bn, :][..., : t - n0, :]   # rows past T are zero
        vt[..., : t - n0, :] = v[..., n0:n0 + bn, :][..., : t - n0, :]
        s = mma(np.zeros((*lead, t, bn), np.float32), q, np.swapaxes(kt, -1, -2), passes)
        s = np.where(n0 + np.arange(bn) < t, s * sl2, -np.inf).astype(np.float32)
        mn = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp2(m - mn).astype(np.float32)
        p = np.exp2(s - mn).astype(np.float32)
        l = (l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
        acc = mma((acc * alpha).astype(np.float32), p, vt, passes)
        m = mn
    return (acc / l).astype(np.float32)


def attention64(q, k, v, scale: float) -> np.ndarray:
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = q @ np.swapaxes(k, -1, -2) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def within_gate(ours, ref) -> bool:
    return bool(np.all(np.abs(ours - ref) <= 1e-4 + 1e-3 * np.abs(ref)))


def qkv(rng, shape, true_lanes=None):
    x = rng.standard_normal((3, *shape)).astype(np.float32)
    if true_lanes is not None:
        x[..., true_lanes:] = 0.0
    return x


@pytest.mark.parametrize("shape", [(2, 3, 250, 64), (1, 4, 68, 64), (2, 2, 50, 16)])
def test_3xtf32_body_matches_float64_attention(rng, shape):
    """250 keys: three full tiles and a ragged one; 68: one full, one of 4."""
    q, k, v = qkv(rng, shape)
    scale = shape[-1] ** -0.5
    ours = body(q, k, v, scale)
    assert ours.shape == shape and np.isfinite(ours).all()
    assert within_gate(ours, attention64(q, k, v, scale))


def test_3xtf32_body_padded_lanes_are_exactly_zero(rng):
    """K9: heads of 64 values zero-padded to 128 lanes, 16-key tiles."""
    q, k, v = qkv(rng, (1, 3, 100, 128), true_lanes=64)
    ours = body(q, k, v, 0.125)
    assert not ours[..., 64:].any()
    ref = attention64(q[..., :64], k[..., :64], v[..., :64], 0.125)
    assert within_gate(ours[..., :64], ref)


def test_single_pass_tf32_is_far_less_accurate(rng):
    q, k, v = qkv(rng, (1, 4, 130, 64))
    ref = attention64(q, k, v, 0.125)
    err3 = np.abs(body(q, k, v, 0.125) - ref).max()
    err1 = np.abs(body(q, k, v, 0.125, passes=1) - ref).max()
    assert err1 > 30 * err3
