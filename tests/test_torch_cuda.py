"""PyTorch port, kernels on the card: each CUDA kernel against its plain
version on the same CUDA tensors. Marked ``cuda``; skips without a card.

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: log-mel atol/rtol 2e-3, attention and iSTFT atol 1e-4 / rtol 1e-3.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def test_wave_to_mel_kernel(cuda):
    from quickvc_tpu_torch.dsp.mel import mel_filterbank
    from quickvc_tpu_torch.dsp.stft import wave_to_mel as plain
    from quickvc_tpu_torch.ops import fused_mel

    y = 0.3 * torch.randn(2, 48003, device=cuda, generator=_gen(cuda, 0))
    fb = torch.as_tensor(mel_filterbank(16000, 1280, 80), device=cuda)
    before = fused_mel.STATS.launches
    ours = fused_mel.wave_to_mel(y, 16000, 1280, 320, 1280, 80)
    assert fused_mel.STATS.launches == before + 1
    torch.testing.assert_close(ours, plain(y, fb, 1280, 320, 1280), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("t_len", [37, 250])
def test_attention_kernel_on_qkv_views(cuda, t_len):
    from quickvc_tpu_torch.ops import fused_attention

    qkv = torch.randn(3, t_len, 3 * 768, device=cuda, generator=_gen(cuda, t_len))
    q, k, v = qkv.chunk(3, dim=-1)
    before = fused_attention.STATS.launches
    ours = fused_attention.attention_packed(q, k, v, 12, 0.125)
    assert fused_attention.STATS.launches == before + 1
    torch.testing.assert_close(
        ours, fused_attention.attention_packed_reference(q, k, v, 12, 0.125),
        atol=1e-4, rtol=1e-3)


def test_polar_istft_kernel_on_strided_views(cuda):
    from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as plain
    from quickvc_tpu_torch.ops import fused_istft

    spec = 0.5 * torch.randn(8, 18, 401, device=cuda, generator=_gen(cuda, 1)).transpose(1, 2)
    lm, ph = spec[..., :9], spec[..., 9:]
    before = fused_istft.STATS.launches
    ours = fused_istft.polar_inverse_stft(lm, ph, 16, 4)
    assert fused_istft.STATS.launches == before + 1
    torch.testing.assert_close(ours, plain(lm, ph, 16, 4), atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(
        ours, fused_istft.polar_inverse_stft(lm.contiguous(), ph.contiguous(), 16, 4))
