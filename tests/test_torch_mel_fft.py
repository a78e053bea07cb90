"""PyTorch port, kernel K1's FFT route: a numpy model of the kernel's
arithmetic against the port's plain ``wave_to_mel``, and K1's route rule.

The model takes what the wrapper hands the kernel (``fft_plan``'s plan,
``spec_fft_table``'s twiddles and window, the filterbank and each filter's
nonzero band from ``_mel_tables``) and follows the kernel block by block:
``FFT_TILE_F`` frames a block, their span staged with the reflect-pad index
mapping (frames of a last tile that is partly filled are computed and not
stored), K4's Stockham passes and recombination
(``torch_port_support.kernel_spec``), then each (frame, mel) pair summed in
float32 over its filter's band in order and clamped in the log. The plain
version is held against JAX's ``wave_to_mel_pallas`` by
``tests/test_torch_dsp_ops.py``. No JAX here.

Tolerance: atol 1e-4 on the log-mel (float32 FFTs and sums of a few
thousand terms in another order, on noise whose mel energies are O(1e2)).
"""

import numpy as np
import pytest
import torch

from quickvc_tpu_torch.dsp.stft import wave_to_mel
from quickvc_tpu_torch.ops import fused_mel
from torch_port_support import GRID_MEL, divisors, jax_mel_accepts, kernel_spec

SR, N_MELS = 16000, 80


def kernel_mel(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """(B, T) float32 -> (B, T//hop, N_MELS) log-mel, as K1's FFT route computes it."""
    fb, bands = fused_mel._mel_tables(SR, n_fft, N_MELS, 0.0, None)
    b, t = y.shape
    n_frames, pad, tile = t // hop, (n_fft - hop) // 2, fused_mel.FFT_TILE_F
    out = np.empty((b, n_frames, N_MELS), np.float32)
    for p0 in range(0, n_frames, tile):
        s = p0 * hop + np.arange((tile - 1) * hop + n_fft) - pad
        s = np.where(s < 0, -s, s)
        s = np.where(s >= t, 2 * (t - 1) - s, s)
        span = np.where((s >= 0) & (s < t), y[:, np.clip(s, 0, t - 1)], 0.0)
        frames = np.stack([span[:, f * hop: f * hop + n_fft] for f in range(tile)], 1)
        mag = kernel_spec(frames.reshape(-1, n_fft).astype(np.float32), n_fft, win)
        mag = mag.reshape(b, tile, -1)[:, : min(tile, n_frames - p0)]
        acc = np.zeros(mag.shape[:2] + (N_MELS,), np.float32)
        lo, width = bands[:, 0], bands[:, 1] - bands[:, 0]
        for j in range(int(width.max())):      # k = lo + j, in order, for the bands that reach it
            k = np.minimum(lo + j, mag.shape[-1] - 1)
            term = np.where(j < width, fb[np.arange(N_MELS), k] * mag[..., k], 0.0)
            acc = (acc + term.astype(np.float32)).astype(np.float32)
        out[:, p0: p0 + mag.shape[1]] = np.log(np.maximum(acc, 1e-5))
    return out


@pytest.mark.parametrize("n_fft,hop,t_len", [
    (1280, 320, 33 * 320 + 17),   # 33 frames: the last tile holds one
    (1280, 320, 481),             # just longer than the 480-sample pad: one frame
    (2048, 512, 20 * 512 + 300),  # 20 frames, T not a multiple of hop
    (2048, 512, 769),             # just longer than the 768-sample pad
])
def test_model_matches_plain_wave_to_mel(rng, n_fft, hop, t_len):
    y = (0.3 * rng.standard_normal((2, t_len))).astype(np.float32)
    fb = torch.as_tensor(fused_mel._mel_tables(SR, n_fft, N_MELS, 0.0, None)[0])
    ref = wave_to_mel(torch.from_numpy(y), fb, n_fft, hop, n_fft).numpy()
    ours = kernel_mel(y, n_fft, hop, n_fft)
    assert fused_mel.mel_route(n_fft, hop) == "fft"
    assert ours.shape == ref.shape == (2, t_len // hop, N_MELS)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_bands_hold_every_nonzero_tap():
    """The band sum skips only zeros of the filterbank."""
    for n_fft in (1280, 2048):
        fb, bands = fused_mel._mel_tables(SR, n_fft, N_MELS, 0.0, None)
        k = np.arange(fb.shape[1])
        inside = (k >= bands[:, :1]) & (k < bands[:, 1:])
        assert not fb[~inside].any() and (bands[:, 1] > bands[:, 0]).all()


@pytest.mark.parametrize("n_fft,hop", GRID_MEL)
def test_mel_route_takes_the_jax_sizes(n_fft, hop):
    assert jax_mel_accepts(n_fft, hop)
    assert fused_mel.mel_route(n_fft, hop) == ("fft" if n_fft in fused_mel.FFT_SIZES
                                               else "dense")


def test_mel_route_covers_every_jax_size():
    """Every (n_fft, hop) the JAX kernel accepts up to MAX_N_FFT has a route:
    the FFT exactly for FFT_SIZES, the dense DFT otherwise."""
    for n_fft in range(2, fused_mel.MAX_N_FFT + 1):
        for hop in divisors(n_fft):
            if jax_mel_accepts(n_fft, hop):
                want = "fft" if n_fft in fused_mel.FFT_SIZES else "dense"
                assert fused_mel.mel_route(n_fft, hop) == want


@pytest.mark.parametrize("n_fft,hop", [(8192, 2048), (4097, 4097), (1280, 0), (1280, 1281)])
def test_mel_route_refuses_past_the_bound(n_fft, hop):
    with pytest.raises(ValueError, match="n_fft"):
        fused_mel.mel_route(n_fft, hop)


def test_launch_counts_by_route():
    """The wrapper's stats count launches in all and by route, and reset both."""
    from quickvc_tpu_torch import ops

    stats = fused_mel.STATS
    ops.reset_launch_counts()
    stats.count("fft")
    stats.count("fft")
    stats.count("dense")
    assert stats.launches == 3 and stats.routes == {"fft": 2, "dense": 1}
    ops.reset_launch_counts()
    assert stats.launches == 0 and not stats.routes
