"""PyTorch port, the sizes kernels K1, K3 and K4 take on the card.

- K1 (``ops.fused_mel.check_n_fft``) and K4 (``ops.fused_mel.spec_route``)
  accept every (n_fft, hop) that the JAX kernels' asserts accept
  (``quickvc_tpu/ops/fused_mel.py``: hop | n_fft and hop | 2*((n_fft-hop)//2))
  up to n_fft 4096, K4 on its real FFT for ``FFT_SIZES`` and on the dense DFT
  otherwise; past 4096 both raise ``ValueError``.
- K3 (``ops.fused_istft.istft_route``) accepts every pair that the JAX head
  asserts (``quickvc_tpu/ops/fused_istft.py``: hop | n_fft, n_fft/hop even,
  n_fft/hop - 1 <= 128) up to n_fft 2048 and refuses the rest.
- K3's run-time body, emulated in numpy on the table the wrapper hands it
  (``istft_table``) with the kernel's own per-sample arithmetic, against the
  plain version (atol 1e-5: float32 sums of a few hundred terms).

The asserts are restated as arithmetic (the log-mel rule in
``torch_port_support``), so no JAX is imported.
"""

import numpy as np
import pytest
import torch

from quickvc_tpu_torch.dsp.istft import polar_inverse_stft
from quickvc_tpu_torch.ops import fused_istft, fused_mel
from torch_port_support import GRID_MEL, divisors, jax_mel_accepts


def jax_istft_accepts(n_fft: int, hop: int) -> bool:
    return n_fft % hop == 0 and (n_fft // hop) % 2 == 0 and n_fft // hop - 1 <= 128


GRID_ISTFT = [(16, 4), (32, 8), (64, 16), (256, 64), (48, 4), (2048, 16), (2048, 1024)]


@pytest.mark.parametrize("n_fft,hop", GRID_MEL)
def test_mel_and_spec_take_the_jax_sizes(n_fft, hop):
    assert jax_mel_accepts(n_fft, hop)
    fused_mel.check_n_fft("wave_to_mel", n_fft, hop)
    assert fused_mel.spec_route(n_fft, hop) == ("fft" if n_fft in fused_mel.FFT_SIZES
                                                else "dense")


def test_every_jax_mel_size_has_a_route():
    routes = {"fft": 0, "dense": 0}
    for n_fft in range(2, fused_mel.MAX_N_FFT + 1):
        for hop in divisors(n_fft):
            if jax_mel_accepts(n_fft, hop):
                fused_mel.check_n_fft("wave_to_mel", n_fft, hop)
                routes[fused_mel.spec_route(n_fft, hop)] += 1
    assert routes["fft"] > 0 and routes["dense"] > routes["fft"]


@pytest.mark.parametrize("n_fft,hop", [(8192, 2048), (4097, 4097), (4100, 1025), (800, 0),
                                       (800, 801)])
def test_mel_and_spec_refuse_past_the_bound(n_fft, hop):
    with pytest.raises(ValueError, match="n_fft"):
        fused_mel.check_n_fft("wave_to_mel", n_fft, hop)
    with pytest.raises(ValueError, match="n_fft"):
        fused_mel.spec_route(n_fft, hop)


@pytest.mark.parametrize("n_fft,hop", GRID_ISTFT)
def test_istft_takes_the_jax_sizes(n_fft, hop):
    assert jax_istft_accepts(n_fft, hop)
    assert fused_istft.istft_route(n_fft, hop) == ("compiled" if (n_fft, hop) == (16, 4)
                                                   else "table")


def test_istft_route_is_the_jax_rule_up_to_2048():
    """Every divisor hop of every n_fft up to 2048 (other hops: the refusals below)."""
    for n_fft in range(1, fused_istft.MAX_N_FFT + 1):
        for hop in divisors(n_fft):
            if jax_istft_accepts(n_fft, hop):
                fused_istft.istft_route(n_fft, hop)
            else:
                with pytest.raises(ValueError, match="n_fft"):
                    fused_istft.istft_route(n_fft, hop)


@pytest.mark.parametrize("n_fft,hop", [(4096, 1024), (2050, 1025), (16, 16), (16, 5),
                                       (24, 8), (258, 1), (16, 0)])
def test_istft_refuses_other_sizes(n_fft, hop):
    with pytest.raises(ValueError, match="n_fft"):
        fused_istft.istft_route(n_fft, hop)


def rt_body(log_mag: np.ndarray, phase: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(rows, F, n_fft/2+1) -> (rows, hop*(F-1)) as polar_istft_kernel_rt
    computes it: per output sample, over the frames that cover it."""
    table = fused_istft.istft_table(n_fft)
    cs, sn, wn, w2 = table.reshape(4, n_fft)
    half = n_fft // 2
    mag = np.exp(log_mag)
    ph = np.float32(3.14159265358979) * np.sin(phase)
    re, im = mag * np.cos(ph), mag * np.sin(ph)
    rows, frames, _ = log_mag.shape
    u = np.arange(hop * (frames - 1)) + half
    y = np.zeros((rows, u.size), np.float32)
    env = np.zeros(u.size)
    k = np.arange(1, half)
    for t in range(frames):
        n = u - t * hop
        ok = (n >= 0) & (n < n_fft)
        nn = n[ok]
        idx = (k[:, None] * nn[None, :]) % n_fft                   # (k, samples)
        acc = re[:, t, 1:half] @ cs[idx] - im[:, t, 1:half] @ sn[idx]
        edge = re[:, t, :1] + np.where(nn % 2, -1.0, 1.0) * re[:, t, half:half + 1]
        y[:, ok] += (edge + 2.0 * acc) * wn[nn]
        env[ok] += w2[nn]
    return y * np.where(env < 1e-11, 1.0, 1.0 / env).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(32, 8), (64, 16), (48, 4), (256, 128)])
def test_istft_table_body_matches_the_plain_version(rng, n_fft, hop):
    spec = (0.5 * rng.standard_normal((2, 23, n_fft + 2))).astype(np.float32)
    lm, ph = spec[..., : n_fft // 2 + 1], spec[..., n_fft // 2 + 1:]
    ours = rt_body(lm, ph, n_fft, hop)
    ref = polar_inverse_stft(torch.from_numpy(lm), torch.from_numpy(ph), n_fft, hop).numpy()
    assert ours.shape == ref.shape == (2, hop * 22)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
