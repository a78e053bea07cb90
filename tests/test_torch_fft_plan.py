"""PyTorch port, kernel K4's FFT plan: a numpy Stockham FFT driven by the
radix plan and the twiddle/window table that ``ops.fused_mel`` hands the
CUDA kernel, with the kernel's own index arithmetic (even/odd packing of the
windowed frame, one pass per radix, the real-from-half-complex
recombination), against ``np.fft.rfft`` of the windowed frames.

Tolerance: atol 1e-5 x the frame's norm (a float32 FFT of up to 1,024
complex points: ~log2(n) roundings of each value).
"""

import numpy as np
import pytest

from quickvc_tpu_torch.dsp.stft import padded_window
from quickvc_tpu_torch.ops import fused_mel


def _dft(v):
    """Radix-len(v) butterfly: the length-R DFT of R complex rows."""
    r = len(v)
    w = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r).astype(np.complex64)
    return [sum(w[q, s] * v[s] for s in range(r)) for q in range(r)]


def kernel_spec(frames: np.ndarray, n_fft: int, win: int) -> np.ndarray:
    """(F, n_fft) float32 frames -> (F, n_fft/2+1) magnitudes, as K4 computes them."""
    radices = fused_mel.fft_plan(n_fft)
    table = fused_mel.spec_fft_table(n_fft, win)
    m = n_fft // 2
    window = table[table.size - n_fft:]
    z = (frames[:, 0::2] * window[0::2]) + 1j * (frames[:, 1::2] * window[1::2])
    off, ns = 0, 1
    for r in radices:                       # Stockham pass: z -> out
        nb = m // r
        j = np.arange(nb)
        k = j % ns
        v = [z[:, j + q * nb] for q in range(r)]
        for q in range(1, r):
            at = off + 2 * (k * (r - 1) + q - 1)
            v[q] = v[q] * (table[at] + 1j * table[at + 1]).astype(np.complex64)
        out = np.empty_like(z)
        for q, vq in enumerate(_dft(v)):
            out[:, (j - k) * r + k + q * ns] = vq
        z, off, ns = out, off + 2 * ns * (r - 1), ns * r
    assert ns == m
    k = np.arange(m + 1)
    tw = table[off + 2 * k] + 1j * table[off + 2 * k + 1]
    zk, zc = z[:, k % m], np.conj(z[:, (m - k) % m])
    x = 0.5 * (zk + zc) - 0.5j * tw * (zk - zc)
    x[:, 0] = z[:, 0].real + z[:, 0].imag     # bins 0 and n_fft/2 apart, exactly
    x[:, m] = z[:, 0].real - z[:, 0].imag
    return np.sqrt(x.real ** 2 + x.imag ** 2 + 1e-6).astype(np.float32)


@pytest.mark.parametrize("n_fft", [256, 640, 1024, 1280, 2048])
def test_plan_and_table_give_the_rfft(rng, n_fft):
    win = n_fft if n_fft != 1024 else 800          # one window shorter than n_fft
    frames = (0.3 * rng.standard_normal((6, n_fft))).astype(np.float32)
    frames[0] = 0.0
    frames[1, :] = 1.0
    ours = kernel_spec(frames, n_fft, win)
    ref = np.abs(np.fft.rfft(frames.astype(np.float64) * padded_window(n_fft, win), axis=-1))
    ref = np.sqrt(ref ** 2 + 1e-6)
    norm = np.linalg.norm(frames, axis=-1, keepdims=True)
    assert ours.shape == (6, n_fft // 2 + 1)
    assert np.all(np.abs(ours - ref) <= 1e-5 * np.maximum(norm, 1.0))


def test_plan_covers_every_supported_size():
    for n_fft in fused_mel.FFT_SIZES:
        radices = fused_mel.fft_plan(n_fft)
        assert int(np.prod(radices)) == n_fft // 2 and set(radices) <= {2, 4, 5, 8, 16}
        assert len(radices) <= 4                 # the kernel's compiled plans hold up to 4
    assert fused_mel.fft_plan(1280) == (5, 16, 8)
    assert fused_mel.fft_plan(1024) == (8, 8, 8)
    assert fused_mel.fft_plan(320) == (5, 8, 4)


@pytest.mark.parametrize("n_fft", [1536, 1000, 128, 4096, 1281])
def test_plan_refuses_other_sizes(n_fft):
    with pytest.raises(ValueError, match="n_fft"):
        fused_mel.fft_plan(n_fft)
