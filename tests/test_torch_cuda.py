"""PyTorch port, kernels on the card: each CUDA kernel against its plain
version on the same CUDA tensors. Marked ``cuda``; skips without a card.

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: log-mel atol/rtol 2e-3, attention and iSTFT atol 1e-4 / rtol 1e-3,
the halo spectrogram atol/rtol 2e-4 (the JAX gate), the k=5 conv and its
gradients atol 1e-4 / rtol 1e-3, the extractor front atol 5e-4 / rtol 1e-3
(the JAX gate), the transformer layer atol 1e-4 / rtol 1e-3.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def test_wave_to_spec_halo_kernel(cuda):
    from quickvc_tpu_torch.dsp.stft import wave_to_spec_halo as plain
    from quickvc_tpu_torch.ops import fused_mel

    y = 0.3 * torch.randn(3, 37 * 320 + 960, device=cuda, generator=_gen(cuda, 2))
    before = fused_mel.SPEC_STATS.launches
    ours = fused_mel.wave_to_spec_halo(y, 1280, 320, 1280)
    assert fused_mel.SPEC_STATS.launches == before + 1
    assert ours.shape == (3, 37, 641)
    torch.testing.assert_close(ours, plain(y, 1280, 320, 1280), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("shape", [(3, 37, 24, 40), (6, 64, 256, 128)])
def test_conv5_lrelu_kernels(cuda, shape):
    """K5 forward against the plain version; through the autograd.Function,
    K5's dx and K6's dW against the plain flipped conv and shifted products
    on the same dym (the LReLU mask from the kernel's output), db = sum(dym)."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    n, rows, c_in, c_out = shape
    g = _gen(cuda, c_in)
    x = torch.randn(n, rows, c_in, device=cuda, generator=g)
    k = torch.randn(5, c_in, c_out, device=cuda, generator=g) / (5 * c_in) ** 0.5
    b = 0.1 * torch.randn(c_out, device=cuda, generator=g)
    dy = torch.randn(n, rows, c_out, device=cuda, generator=g)
    ins = [t.clone().requires_grad_() for t in (x, k, b)]
    before = (fdc.STATS.launches, fdc.DW_STATS.launches)
    y = fdc.conv5_lrelu(*ins, 0.1)
    y.backward(dy)
    assert (fdc.STATS.launches, fdc.DW_STATS.launches) == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(y, fdc.conv5_lrelu_reference(x, k, b, 0.1), atol=1e-4, rtol=1e-3)
    dym = dy * torch.where(y > 0, 1.0, 0.1)
    xp = F.pad(x, (0, 0, 2, 2))
    plain = [fdc.conv5_lrelu_reference(dym, k.flip(0).transpose(1, 2), None, 1.0),
             torch.stack([torch.einsum("nrc,nro->co", xp[:, dr : dr + rows], dym)
                          for dr in range(5)]),
             dym.sum(dim=(0, 1))]
    for ours, ref in zip(ins, plain):
        torch.testing.assert_close(ours.grad, ref, atol=1e-4, rtol=1e-3)


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


@pytest.mark.parametrize("shape", [(2, 16003, 128), (3, 32083, 512)])
def test_extractor_front_kernel(cuda, shape):
    from quickvc_tpu_torch.ops import fused_extractor as fe

    b, t_len, c = shape
    g = _gen(cuda, t_len)
    wav = 0.3 * torch.randn(b, t_len, device=cuda, generator=g)
    w0 = 0.3 * torch.randn(c, 1, 10, device=cuda, generator=g)
    gamma = 1.0 + 0.1 * torch.randn(c, device=cuda, generator=g)
    beta = 0.1 * torch.randn(c, device=cuda, generator=g)
    w1 = torch.randn(c, c, 3, device=cuda, generator=g) / (3 * c) ** 0.5
    before = fe.STATS.launches
    ours = fe.extractor_front(wav, w0, gamma, beta, w1)
    assert fe.STATS.launches == before + 1
    assert ours.shape == (b, fe.front_rows(t_len), c)
    torch.testing.assert_close(ours, fe.extractor_front_reference(wav, w0, gamma, beta, w1),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("t_len", [37, 300])
def test_transformer_layer_kernel(cuda, t_len):
    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.ops import fused_attention, fused_transformer as ft
    from quickvc_tpu_torch.utils.weights import init_random_

    layer = init_random_(TransformerLayer(use_fused_layer=True), t_len)
    g = torch.Generator().manual_seed(t_len)
    with torch.no_grad():  # biases and norm affines off their init constants
        for p in layer.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    layer = layer.to(cuda).eval()
    x = torch.randn(3, t_len, 768, device=cuda, generator=_gen(cuda, t_len))
    before = (ft.STATS.launches, fused_attention.STATS.launches)
    with torch.inference_mode():
        ours = layer(x)
    assert (ft.STATS.launches, fused_attention.STATS.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(ours, ft.transformer_layer_reference(x, layer),
                               atol=1e-4, rtol=1e-3)
