"""PyTorch port, kernel K3's compiled 16/4 body on the CPU: its grid plan,
its host-built tables and a numpy model of its arithmetic.

- :func:`model_body` computes what ``csrc/fused_istft.cu:polar_istft_kernel``
  computes, block by block and step by step on the plan
  (``ops.fused_istft.istft_plan``): each block's span of chunk slots, its
  first step decoding every frame it reads and each later one carrying the
  R-1 frames it shares with the one before, each frame decoded as the
  kernel decodes it (``expf``, ``sinf``, then ``sincospif`` of the sine:
  the cosine and sine of pi times it, each rounded once to float32; a
  frame outside [0, F) as log_mag -inf and phase 0) and contracted with the
  half of the host's basis that its symmetry does not repeat
  (``compiled_tables``), the chunks' frame-shifted sums, the envelope read from its
  head, interior and tail chunks, one 4-sample chunk a thread. It is held against the plain
  ``dsp.istft.polar_inverse_stft`` at 1e-5 absolute (float32 sums of 36
  products a sample) and once against the JAX ``polar_inverse_stft_pallas``
  in interpret mode at the kernel's gate, 1e-4 / 1e-3.
- The envelope table expands to the JAX package's float32 envelope exactly.
- The plan writes every output chunk of every row once, at the conversion,
  streaming, live and parity shapes, and spreads a live tick of one stream
  over far more than 24 SMs.
- The wrapper hands the kernel the plan's grid and the tables (the library
  faked: no card here).
"""

import ctypes

import numpy as np
import pytest
import torch

from quickvc_tpu_torch.dsp.istft import polar_inverse_stft
from quickvc_tpu_torch.ops import fused_istft as fi

N_FFT, HOP = fi.COMPILED
R = N_FFT // HOP
NF = N_FFT // 2 + 1


def split_tables(tables: np.ndarray):
    """compiled_tables -> (basis re part (9, 9), negated im part (7, 7),
    envelope (3, 4))."""
    re_t, im_t, env = np.split(tables, np.cumsum([NF * NF, (NF - 2) ** 2]))
    return re_t.reshape(NF, NF), im_t.reshape(NF - 2, NF - 2), env.reshape(2 * fi.EDGE + 1, HOP)


def envelope_row(env: np.ndarray, n_chunks: int) -> np.ndarray:
    """The envelope of ``n_chunks`` output chunks, (n_chunks * hop,), as the
    compiled body reads it from the table's (2 EDGE + 1, hop) head, interior
    and tail chunks: chunk p < EDGE from the head, p >= n_chunks - EDGE from
    the tail, any other from the interior."""
    p = np.arange(n_chunks)
    e = np.where(p < fi.EDGE, p, np.where(p >= n_chunks - fi.EDGE,
                                          2 * fi.EDGE + 1 - (n_chunks - p), fi.EDGE))
    return env[e].reshape(-1)


def decode_frames(lm: np.ndarray, ph: np.ndarray, v: np.ndarray, n_frames: int,
                  tables: np.ndarray) -> np.ndarray:
    """Virtual frames ``v`` of the rows laid end to end -> (len(v), N_FFT)
    windowed samples, float32; a frame outside [0, F) reads log_mag -inf and
    phase 0, which decode to zeros."""
    row_len = n_frames + 2 * fi.EDGE
    r = v // row_len
    t = v - r * row_len - fi.EDGE
    ok = (t >= 0) & (t < n_frames)
    tt = np.clip(t, 0, n_frames - 1)
    lm_v = np.where(ok[:, None], lm[r, tt], np.float32(-np.inf))
    ph_v = np.where(ok[:, None], ph[r, tt], np.float32(0.0))
    mag = np.exp(lm_v)                                          # expf
    s = np.sin(ph_v).astype(np.float64)                         # sinf
    cs = np.cos(np.pi * s).astype(np.float32)                   # sincospif
    sn = np.sin(np.pi * s).astype(np.float32)
    re, im = mag * cs, mag * sn
    re_t, im_t, _ = split_tables(tables)
    a = np.zeros((len(v), NF), np.float32)
    b = np.zeros((len(v), NF - 2), np.float32)
    for k in range(NF):
        a = re[:, k, None] * re_t[k] + a
        if 0 < k < NF - 1:
            b = im[:, k, None] * im_t[k - 1] + b
    y = np.zeros((len(v), N_FFT), np.float32)
    y[:, 0], y[:, NF - 1] = a[:, 0], a[:, NF - 1]
    for n in range(1, NF - 1):
        y[:, n] = a[:, n] - b[:, n - 1]
        y[:, N_FFT - n] = a[:, n] + b[:, n - 1]
    assert not y[~ok].any()
    return y


def model_body(lm: np.ndarray, ph: np.ndarray, plan: fi.IstftPlan):
    """(rows, F, 9) x2 float32 -> (rows, 4 (F-1)) and how often each output
    chunk was written, as the compiled body computes them on ``plan``."""
    rows, n_frames, _ = lm.shape
    row_len, n_chunks = n_frames + 2 * fi.EDGE, n_frames - 1
    tables = fi.compiled_tables(min(n_frames, R))
    env = envelope_row(split_tables(tables)[2], n_chunks).reshape(n_chunks, HOP)
    out = np.full((rows, n_chunks, HOP), np.nan, np.float32)
    writes = np.zeros((rows, n_chunks), np.int64)
    for b in range(plan.blocks):
        halo = np.zeros((0, N_FFT), np.float32)
        for c0, n in plan.steps(b):
            lead = len(halo)                        # 0 in a span's first step, else R - 1
            new = decode_frames(lm, ph, c0 + lead + np.arange(n + R - 1 - lead), n_frames,
                                tables)
            buf = np.concatenate([halo, new])       # frame c0 + s at slot s
            i = np.arange(n)
            y = np.zeros((n, HOP), np.float32)
            for j in range(R):                      # frame p + R/2 - j, samples [j hop, (j+1) hop)
                y = y + buf[i + R - 1 - j, j * HOP:(j + 1) * HOP]
            c = c0 + i
            r, p = c // row_len, c % row_len
            keep = p < n_chunks
            out[r[keep], p[keep]] = y[keep] * env[p[keep]]
            np.add.at(writes, (r[keep], p[keep]), 1)
            halo = buf[n:n + R - 1]
    return out.reshape(rows, -1), writes


def edges_hit(plan: fi.IstftPlan, n_frames: int) -> set[str]:
    """Where the plan's step starts fall in their rows: "first" for the
    first R-1 chunks, "last" for the last R-1, "ragged" if a span ends in a
    partial step."""
    row_len, n_chunks = n_frames + 2 * fi.EDGE, n_frames - 1
    hits = set()
    for b in range(plan.blocks):
        steps = plan.steps(b)
        if steps[-1][1] < plan.tile - (R - 1 if len(steps) == 1 else 0):
            hits.add("ragged")
        for c0, _ in steps:
            p = c0 % row_len
            hits |= {"first"} if p < R - 1 else set()
            hits |= {"last"} if n_chunks - (R - 1) <= p < n_chunks else set()
    return hits


# (rows, F, blocks): F = 2, F = 3, step and span starts inside the first and
# the last R-1 chunks of a row, a ragged last step (checked by edges_hit)
CASES = [(3, 2, 1), (2, 3, 2), (2, 22, 5), (2, 253, 4)]
EDGES = {(2, 22, 5): {"first", "last"}, (2, 253, 4): {"first", "last", "ragged"}}


def spectra(rows: int, n_frames: int, seed: int):
    rng = np.random.default_rng(seed)
    spec = (0.5 * rng.standard_normal((rows, 2 * NF, n_frames))).astype(np.float32)
    return (np.ascontiguousarray(spec[:, :NF].transpose(0, 2, 1)),
            np.ascontiguousarray(spec[:, NF:].transpose(0, 2, 1)))


def case_plan(rows: int, n_frames: int, blocks: int) -> fi.IstftPlan:
    return fi.istft_plan(rows, n_frames)._replace(blocks=blocks)


@pytest.mark.parametrize("rows,n_frames,blocks", CASES)
def test_model_body_matches_the_plain_version(rows, n_frames, blocks):
    plan = case_plan(rows, n_frames, blocks)
    assert EDGES.get((rows, n_frames, blocks), set()) <= edges_hit(plan, n_frames)
    lm, ph = spectra(rows, n_frames, n_frames)
    ours, writes = model_body(lm, ph, plan)
    assert (writes == 1).all()
    ref = polar_inverse_stft(torch.from_numpy(lm), torch.from_numpy(ph), N_FFT, HOP).numpy()
    assert ours.shape == ref.shape == (rows, HOP * (n_frames - 1))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_model_body_matches_pallas():
    """The model against the TPU kernel itself (interpret mode) at every case."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from quickvc_tpu.ops.fused_istft import polar_inverse_stft_pallas

    for rows, n_frames, blocks in CASES:
        lm, ph = spectra(rows, n_frames, n_frames + 1)
        ours, _ = model_body(lm, ph, case_plan(rows, n_frames, blocks))
        with pltpu.force_tpu_interpret_mode():
            golden = np.asarray(polar_inverse_stft_pallas(jnp.asarray(lm), jnp.asarray(ph),
                                                          N_FFT, HOP))
        np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("n_frames", [2, 3, 41, 1361, 1601, 5001, 5761])
def test_envelope_table_is_the_jax_envelope(n_frames):
    from quickvc_tpu.dsp.istft import _ola_envelope

    half = N_FFT // 2
    jax_env = _ola_envelope(n_frames, N_FFT, HOP)[half:-half]
    table = split_tables(fi.compiled_tables(min(n_frames, R)))[2]
    assert jax_env.dtype == table.dtype == np.float32
    np.testing.assert_array_equal(envelope_row(table, n_frames - 1), jax_env)
    np.testing.assert_array_equal(fi.compiled_tables(n_frames),
                                  fi.compiled_tables(min(n_frames, R)))


def test_tables_hold_the_basis():
    """The tables are the plain version's windowed inverse-DFT basis where
    its symmetry does not repeat it, and unfolded by that symmetry they give
    back the whole basis (within an ulp: the float64 window is symmetric to
    its last bit or two)."""
    from quickvc_tpu_torch.dsp.istft import _inverse_dft_matrices

    tables = fi.compiled_tables(5001)
    assert tables.dtype == np.float32
    assert tables.size == NF * NF + (NF - 2) ** 2 + (R - 1) * HOP
    re_t, im_t, _ = split_tables(tables)
    basis_re, basis_im = _inverse_dft_matrices(N_FFT)
    np.testing.assert_array_equal(re_t, basis_re[:, :NF])
    np.testing.assert_array_equal(im_t, -basis_im[1:NF - 1, 1:NF - 1])
    fold = np.minimum(np.arange(N_FFT), N_FFT - np.arange(N_FFT))   # n or N - n
    sign = np.where(np.arange(N_FFT) > N_FFT // 2, 1.0, -1.0)
    im_full = np.zeros((NF, NF), np.float32)
    im_full[1:-1, 1:-1] = im_t
    np.testing.assert_allclose(re_t[:, fold], basis_re, rtol=2e-7, atol=1e-12)
    np.testing.assert_allclose(sign * im_full[:, fold], basis_im, rtol=2e-7, atol=1e-12)


def live_shapes() -> list[tuple[int, int]]:
    from quickvc_tpu_torch.scripts import realtime_bench

    windows = sorted({c + left + right for _, _, c, left, right in realtime_bench.POINTS})
    return [(4 * n, 20 * w + 1) for n in (1, 8, 64) for w in windows]


PLAN_SHAPES = [(32, 5001), (32, 20 * 288 + 1), (8, 20 * 208 + 1), (1, 2), (1, 3), (5, 7),
               (3, 129), (7, 1000), (2, 4096)]


@pytest.mark.parametrize("shape", PLAN_SHAPES + live_shapes())
def test_plan_writes_every_chunk_once(shape):
    """Conversion (32, 5001), streaming (32, 5761), parity (8, 4161), the live
    windows at N = 1, 8, 64 and ragged F: the spans partition the chunk
    slots, and the live ones map onto every (row, chunk) exactly once."""
    rows, n_frames = shape
    plan = fi.istft_plan(rows, n_frames)
    spans = [plan.span(b) for b in range(plan.blocks)]
    assert spans[0][0] == 0 and spans[-1][1] == plan.slots
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    lengths = [e - b for b, e in spans]
    assert max(lengths) - min(lengths) <= 1 and plan.blocks <= -(-plan.slots // fi.MIN_SPAN)
    for b, (begin, end) in enumerate(spans):   # steps walk the span, the first R - 1 short
        steps = plan.steps(b)
        assert [c0 for c0, _ in steps] == list(np.cumsum([begin] + [n for _, n in steps[:-1]]))
        assert sum(n for _, n in steps) == end - begin
        assert steps[0][1] <= fi.TILE - (R - 1) and all(n <= fi.TILE for _, n in steps)
    row_len = n_frames + 2 * fi.EDGE
    c = np.arange(plan.slots)
    r, p = c // row_len, c % row_len
    live = p < n_frames - 1
    counts = np.zeros((rows, n_frames - 1), np.int64)
    np.add.at(counts, (r[live], p[live]), 1)
    assert (counts == 1).all()
    assert plan.blocks <= 132 * fi.BLOCKS_PER_SM and plan.tile == fi.TILE


def test_plan_fills_the_card():
    """The conversion batch and the streaming window: more than one step a
    block (the next step's loads overlap this one's decode), every block
    resident, no last step of a few chunks. A live tick of one stream takes
    far more than the 24 SMs of a grid of 256-chunk tiles."""
    first = fi.TILE - (R - 1)
    for rows, n_frames in [(32, 5001), (32, 5761), (256, 1601)]:
        plan = fi.istft_plan(rows, n_frames)
        assert plan.blocks <= 132 * fi.BLOCKS_PER_SM
        steps = {len(plan.steps(b)) for b in range(plan.blocks)}
        assert len(steps) == 1 and steps.pop() >= 2
        assert min(plan.steps(b)[-1][1] for b in range(plan.blocks)) > fi.TILE // 2
        assert plan.slots > plan.blocks * (first + fi.TILE * (len(plan.steps(0)) - 2))
    live = fi.istft_plan(4, 1361)
    assert live.blocks > 3 * 24
    assert fi.istft_plan(4, 1361, sm_count=8).blocks == 8 * fi.BLOCKS_PER_SM


def test_wrapper_hands_the_kernel_its_plan_and_tables(monkeypatch):
    """The compiled route gets istft_plan's grid and compiled_tables (host
    memory) and no device table; the table route the device table, no grid."""
    calls = []

    class FakeLib:
        def qvc_polar_istft(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(fi, "require_cuda", lambda *a, **kw: torch.float32)
    monkeypatch.setattr(fi, "library", lambda: FakeLib())
    monkeypatch.setattr(fi, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fi, "device_sms", lambda index: 132)
    fi._compiled_launch.cache_clear()
    for rows, n_frames in [(4, 1361), (32, 5001), (3, 2), (2, 3)]:
        calls.clear()
        before = fi.STATS.launches
        lm = torch.zeros(rows, 2 * NF, n_frames).transpose(1, 2)
        out = fi.polar_inverse_stft_kernel(lm[..., :NF], lm[..., NF:], N_FFT, HOP)
        assert out.shape == (rows, HOP * (n_frames - 1))
        assert fi.STATS.launches == before + 1
        args = calls[0]
        assert args[2:8] == (2 * NF * n_frames, 1, n_frames) * 2
        assert args[9:13] == (rows, n_frames, N_FFT, HOP)
        table, host, blocks = args[13:16]
        assert table is None and blocks == fi.istft_plan(rows, n_frames, 132).blocks
        want = fi.compiled_tables(n_frames)
        np.testing.assert_array_equal(
            np.ctypeslib.as_array((ctypes.c_float * want.size).from_address(host)), want)
    calls.clear()
    lm = torch.zeros(2, 23, 17)
    fi.polar_inverse_stft_kernel(lm, lm, 32, 8)
    table, host, blocks = calls[0][13:16]
    assert table == fi._device_table(lm.device, 32).data_ptr()
    assert host is None and blocks == 0
