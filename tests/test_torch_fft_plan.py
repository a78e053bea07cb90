"""PyTorch port, kernel K4's FFT plan: a numpy Stockham FFT driven by the
radix plan and the twiddle/window table that ``ops.fused_mel`` hands the
CUDA kernel, with the kernel's own index arithmetic (even/odd packing of the
windowed frame, one pass per radix, the real-from-half-complex
recombination; ``torch_port_support.kernel_spec``, which K1's FFT route
shares), against ``np.fft.rfft`` of the windowed frames.

Tolerance: atol 1e-5 x the frame's norm (a float32 FFT of up to 1,024
complex points: ~log2(n) roundings of each value).
"""

import numpy as np
import pytest

from quickvc_tpu_torch.dsp.stft import padded_window
from quickvc_tpu_torch.ops import fused_mel
from torch_port_support import kernel_spec


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
