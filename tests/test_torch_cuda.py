"""PyTorch port, kernels on the card: each CUDA kernel against its plain
version on the same CUDA tensors. Marked ``cuda``; skips without a card.

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: log-mel atol/rtol 2e-3 (n_fft/hop 1280/320 and 2048/512 on its
FFT route, 800/200 and 4096/1024 on its dense DFT), attention
and iSTFT atol 1e-4 / rtol 1e-3 (iSTFT also at 32/8 and 64/16, on its
table-driven body, and at F = 2, F = 3, a ragged F and a live tick on the
compiled one, bit-equal from one launch to the next and strided to
contiguous), the halo spectrogram atol/rtol 2e-4 (the JAX gate) at
n_fft/hop 1280/320 and 1024/256 (real FFT) and 800/200 and 1536/384 (dense
DFT), the k=5 conv and its
gradients atol 1e-4 / rtol 1e-3 (also at the five period discriminators'
full-width shapes, and bit-equal from one launch to the next), the
extractor front atol 5e-4 / rtol 1e-3 (the JAX gate), the transformer layer and the K9/K10 attention layouts atol
1e-4 / rtol 1e-3 (the extractor front and the layer also bit-equal from one
launch to the next), the int8 GEMM exact and its bf16 form atol 2e-3 / rtol
1e-4, streaming and a live session on the card within 1e-3 x peak of the CPU;
K2's bf16 mode within 8e-3 max|v| of its plain version, its error against
float64 attention at most 1.5x the plain version's.
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


@pytest.mark.parametrize("n_fft,hop", [(1280, 320), (1024, 256), (800, 200), (1536, 384)])
def test_wave_to_spec_halo_kernel(cuda, n_fft, hop):
    """37 frames: not a multiple of either route's frame tile. 1280 and 1024
    take the real FFT, 800 and 1536 the dense DFT."""
    from quickvc_tpu_torch.dsp.stft import wave_to_spec_halo as plain
    from quickvc_tpu_torch.ops import fused_mel

    assert fused_mel.spec_route(n_fft, hop) == ("fft" if n_fft in (1280, 1024) else "dense")
    y = 0.3 * torch.randn(3, 37 * hop + n_fft - hop, device=cuda, generator=_gen(cuda, 2))
    before = fused_mel.SPEC_STATS.launches
    ours = fused_mel.wave_to_spec_halo(y, n_fft, hop, n_fft)
    assert fused_mel.SPEC_STATS.launches == before + 1
    assert ours.shape == (3, 37, n_fft // 2 + 1)
    torch.testing.assert_close(ours, plain(y, n_fft, hop, n_fft), atol=2e-4, rtol=2e-4)


def test_wave_to_spec_halo_kernel_refuses_other_sizes(cuda):
    """Past the bound of both routes (n_fft 4096)."""
    from quickvc_tpu_torch.ops import fused_mel

    y = torch.zeros(1, 4 * 8192, device=cuda)
    with pytest.raises(ValueError, match="n_fft"):
        fused_mel.wave_to_spec_halo(y, 8192, 2048, 8192)


# the fifth conv's input at each period of the paired D phase (batch 64,
# segment 10240): x (64 p, R_p, 1024)
PERIOD_SHAPES = [(128, 64, 1024, 1024), (192, 43, 1024, 1024), (320, 26, 1024, 1024),
                 (448, 19, 1024, 1024), (704, 12, 1024, 1024)]


@pytest.mark.parametrize("shape", [(3, 37, 24, 40), (6, 64, 256, 128), (5, 13, 30, 42),
                                   (4, 12, 33, 17)] + PERIOD_SHAPES)
def test_conv5_lrelu_kernels(cuda, shape):
    """K5 forward against the plain version; through the autograd.Function,
    K5's dx and K6's dW against the plain flipped conv and shifted products
    on the same dym (the LReLU mask from the kernel's output), db = sum(dym);
    a second launch of K5 and of K6 gives the same bits. Channels that are
    not multiples of 4 take the 4-byte copies; the period shapes (full
    width, K6 split four ways) scale dy by 1/sqrt(N R) so that dW is O(1)."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    n, rows, c_in, c_out = shape
    g = _gen(cuda, c_in)
    x = torch.randn(n, rows, c_in, device=cuda, generator=g)
    k = torch.randn(5, c_in, c_out, device=cuda, generator=g) / (5 * c_in) ** 0.5
    b = 0.1 * torch.randn(c_out, device=cuda, generator=g)
    dy = torch.randn(n, rows, c_out, device=cuda, generator=g)
    if shape in PERIOD_SHAPES:
        dy = dy / (n * rows) ** 0.5
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
    assert torch.equal(fdc.conv5_lrelu_kernel(x, k, b, 0.1), y.detach())
    assert torch.equal(fdc.conv5_dw_kernel(x, dym.contiguous()), ins[1].grad)


@pytest.mark.parametrize("n_fft,hop", [(1280, 320), (2048, 512), (800, 200)])
def test_wave_to_mel_kernel(cuda, n_fft, hop):
    """1280 and 2048 take the FFT route (K4's real FFT, then the mel sums),
    800 the dense DFT in one bin chunk; 149 frames fill the last FFT tile
    (2 frames) only partly."""
    from quickvc_tpu_torch.dsp.mel import mel_filterbank
    from quickvc_tpu_torch.dsp.stft import wave_to_mel as plain
    from quickvc_tpu_torch.ops import fused_mel

    route = fused_mel.mel_route(n_fft, hop)
    assert route == ("dense" if n_fft == 800 else "fft")
    y = 0.3 * torch.randn(2, 149 * hop + 3, device=cuda, generator=_gen(cuda, 0))
    fb = torch.as_tensor(mel_filterbank(16000, n_fft, 80), device=cuda)
    before = fused_mel.STATS.launches, fused_mel.STATS.routes[route]
    ours = fused_mel.wave_to_mel(y, 16000, n_fft, hop, n_fft, 80)
    assert (fused_mel.STATS.launches, fused_mel.STATS.routes[route]) == (before[0] + 1,
                                                                         before[1] + 1)
    torch.testing.assert_close(ours, plain(y, fb, n_fft, hop, n_fft), atol=2e-3, rtol=2e-3)


def test_wave_to_mel_kernel_past_one_bin_chunk(cuda):
    """n_fft 4096 on the dense route: 2049 bins, three chunks of the kernel's 768."""
    from quickvc_tpu_torch.dsp.mel import mel_filterbank
    from quickvc_tpu_torch.dsp.stft import wave_to_mel as plain
    from quickvc_tpu_torch.ops import fused_mel

    assert fused_mel.mel_route(4096, 1024) == "dense"
    y = 0.3 * torch.randn(2, 48003, device=cuda, generator=_gen(cuda, 3))
    fb = torch.as_tensor(mel_filterbank(16000, 4096, 80), device=cuda)
    before = fused_mel.STATS.launches
    ours = fused_mel.wave_to_mel(y, 16000, 4096, 1024, 4096, 80)
    assert fused_mel.STATS.launches == before + 1
    torch.testing.assert_close(ours, plain(y, fb, 4096, 1024, 4096), atol=2e-3, rtol=2e-3)


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


@pytest.mark.parametrize("t_len,d", [(37, 64), (250, 64), (333, 64), (61, 16), (61, 32),
                                     (61, 128)])
def test_attention_bf16_kernel_on_qkv_views(cuda, t_len, d):
    """K2's bf16 mode against its plain version on the same bf16 inputs:
    max |diff| <= 8e-3 max|v|, its error against float64 attention at most
    1.5x the plain version's; counted apart from the float32 launches."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    h = 768 // d if d == 64 else 4
    qkv = torch.randn(3, t_len, 3 * h * d, device=cuda, generator=_gen(cuda, t_len + d))
    q, k, v = qkv.bfloat16().chunk(3, dim=-1)
    before = (fa.STATS.launches, fa.BF16_STATS.launches)
    ours = fa.attention_packed(q, k, v, h, d ** -0.5)
    assert (fa.STATS.launches, fa.BF16_STATS.launches) == (before[0], before[1] + 1)
    plain = fa.attention_packed_reference(q, k, v, h, d ** -0.5)
    qh, kh, vh = (z.double().reshape(3, t_len, h, d).transpose(1, 2) for z in (q, k, v))
    exact = (torch.softmax(qh @ kh.transpose(-1, -2) * d ** -0.5, -1) @ vh
             ).transpose(1, 2).reshape(3, t_len, h * d)
    assert ours.dtype == torch.bfloat16
    assert float((ours.float() - plain.float()).abs().max()) <= 8e-3 * float(v.float().abs().max())
    assert (ours.double() - exact).abs().max() <= 1.5 * (plain.double() - exact).abs().max()


def test_attention_bf16_kernel_refuses_mixed_dtypes(cuda):
    from quickvc_tpu_torch.ops import fused_attention as fa

    q = torch.zeros(1, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        fa.attention_packed_kernel(q, q.bfloat16(), q, 1, 0.125)
    with pytest.raises(TypeError, match="ROADMAP A21"):
        fa.attention_kernel(*(q.bfloat16()[:, None],) * 3, 0.125)


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


@pytest.mark.parametrize("rows,n_frames", [(3, 2), (2, 3), (5, 1000), (4, 1361)])
def test_polar_istft_compiled_body(cuda, rows, n_frames):
    """The compiled 16/4 body at F = 2 and 3, a ragged F and a live tick of
    one stream (4 x 1361 frames, istft_plan's grid of small spans), against
    the plain version; two launches, and the strided and contiguous views,
    give the same bits."""
    from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as plain
    from quickvc_tpu_torch.ops import fused_istft

    spec = 0.5 * torch.randn(rows, 18, n_frames, device=cuda,
                             generator=_gen(cuda, n_frames)).transpose(1, 2)
    lm, ph = spec[..., :9], spec[..., 9:]
    before = fused_istft.STATS.launches
    ours = fused_istft.polar_inverse_stft(lm, ph, 16, 4)
    assert fused_istft.STATS.launches == before + 1
    assert ours.shape == (rows, 4 * (n_frames - 1))
    ref = plain(lm, ph, 16, 4)
    torch.testing.assert_close(ours, ref, atol=1e-4, rtol=1e-3)
    assert torch.equal(ours, fused_istft.polar_inverse_stft(lm, ph, 16, 4))
    assert torch.equal(ours, fused_istft.polar_inverse_stft(lm.contiguous(), ph.contiguous(),
                                                            16, 4))


@pytest.mark.parametrize("n_fft,hop", [(32, 8), (64, 16)])
def test_polar_istft_kernel_other_sizes(cuda, n_fft, hop):
    """The table-driven body, on strided views as the decoder passes them."""
    from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as plain
    from quickvc_tpu_torch.ops import fused_istft

    n_freq = n_fft // 2 + 1
    spec = 0.5 * torch.randn(8, 2 * n_freq, 401, device=cuda,
                             generator=_gen(cuda, n_fft)).transpose(1, 2)
    lm, ph = spec[..., :n_freq], spec[..., n_freq:]
    before = fused_istft.STATS.launches
    ours = fused_istft.polar_inverse_stft(lm, ph, n_fft, hop)
    assert fused_istft.STATS.launches == before + 1
    assert ours.shape == (8, hop * 400)
    torch.testing.assert_close(ours, plain(lm, ph, n_fft, hop), atol=1e-4, rtol=1e-3)


def _front_inputs(dev, b, t_len, c):
    g = _gen(dev, t_len)
    wav = 0.3 * torch.randn(b, t_len, device=dev, generator=g)
    w0 = 0.3 * torch.randn(c, 1, 10, device=dev, generator=g)
    gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
    beta = 0.1 * torch.randn(c, device=dev, generator=g)
    w1 = torch.randn(c, c, 3, device=dev, generator=g) / (3 * c) ** 0.5
    return wav, w0, gamma, beta, w1


@pytest.mark.parametrize("shape", [(2, 16003, 128), (3, 32083, 512), (2, 3013, 64),
                                   (1, 1333, 512)])
def test_extractor_front_kernel(cuda, shape):
    """Also C = 64 (a 512-channel tile mostly past C) and n1 = 300 and 132,
    ragged against the 64-row tiles."""
    from quickvc_tpu_torch.ops import fused_extractor as fe

    b, t_len, c = shape
    front = _front_inputs(cuda, b, t_len, c)
    before = fe.STATS.launches
    ours = fe.extractor_front(*front)
    assert fe.STATS.launches == before + 1
    assert ours.shape == (b, fe.front_rows(t_len), c)
    torch.testing.assert_close(ours, fe.extractor_front_reference(*front), atol=5e-4, rtol=1e-3)


def test_extractor_front_kernel_is_deterministic(cuda):
    from quickvc_tpu_torch.ops import fused_extractor as fe

    front = _front_inputs(cuda, 2, 16003, 512)
    assert torch.equal(fe.extractor_front(*front), fe.extractor_front(*front))


def _fused_layer(dev, seed):
    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.utils.weights import init_random_

    layer = init_random_(TransformerLayer(use_fused_layer=True), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # biases and norm affines off their init constants
        for p in layer.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return layer.to(dev).eval()


@pytest.mark.parametrize("t_len", [37, 300, 250])
def test_transformer_layer_kernel(cuda, t_len):
    """M = 3 T = 111 (every GEMM split four ways), 900 (split and not) and
    750: none a multiple of the 256-row tile."""
    from quickvc_tpu_torch.ops import fused_attention, fused_transformer as ft

    layer = _fused_layer(cuda, t_len)
    x = torch.randn(3, t_len, 768, device=cuda, generator=_gen(cuda, t_len))
    before = (ft.STATS.launches, fused_attention.STATS.launches)
    with torch.inference_mode():
        ours = layer(x)
    assert (ft.STATS.launches, fused_attention.STATS.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(ours, ft.transformer_layer_reference(x, layer),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("batch", [1, 16])
def test_transformer_layer_kernel_is_deterministic(cuda, batch):
    """Split-K (batch 1: M = 300) and not (batch 16: M = 4,800, the encoding
    batch): the same bits from two launches."""
    from quickvc_tpu_torch.ops import fused_transformer as ft

    layer = _fused_layer(cuda, 5)
    x = torch.randn(batch, 300, 768, device=cuda, generator=_gen(cuda, 5))
    plans = ft.layer_plans(batch * 300, 768, 3072)
    assert any(p.splits > 1 for p in plans) == (batch == 1)
    with torch.inference_mode():
        assert torch.equal(ft.transformer_layer(x, layer), ft.transformer_layer(x, layer))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_headed_attention_kernel(cuda, d):
    """K10 at each compiled head dim, on (B, H, T, D) views of packed rows."""
    from quickvc_tpu_torch.ops import fused_attention

    b, h, t_len = 2, 3, 77
    qkv = torch.randn(b, t_len, 3, h, d, device=cuda, generator=_gen(cuda, d))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = fused_attention.HEADED_STATS.launches
    ours = fused_attention.attention(q, k, v, d ** -0.5)
    assert fused_attention.HEADED_STATS.launches == before + 1
    torch.testing.assert_close(ours, fused_attention.attention_reference(q, k, v, d ** -0.5),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_headed_attention_kernel_unaligned_strides(cuda, d):
    """K10 on views whose bases and strides are not multiples of 4 floats:
    the body stages K and V with 4-byte copies instead of 16-byte ones."""
    from quickvc_tpu_torch.ops import fused_attention

    b, h, t_len = 2, 3, 77
    qkv = torch.randn(b, t_len, 3, h, d + 1, device=cuda, generator=_gen(cuda, d + 1))
    q, k, v = (qkv[:, :, i, :, 1:].transpose(1, 2) for i in range(3))
    assert k.stride(2) % 4 and v.stride(2) % 4
    ours = fused_attention.attention(q, k, v, d ** -0.5)
    torch.testing.assert_close(ours, fused_attention.attention_reference(q, k, v, d ** -0.5),
                               atol=1e-4, rtol=1e-3)


def test_attention_kernels_refuse_other_head_dims(cuda):
    """A head dim the body is not compiled for raises; nothing is launched."""
    from quickvc_tpu_torch.ops import fused_attention

    x = torch.zeros(1, 8, 2 * 48, device=cuda)
    xh = x.reshape(1, 8, 2, 48).transpose(1, 2)
    before = (fused_attention.STATS.launches, fused_attention.HEADED_STATS.launches)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention.attention_packed(x, x, x, 2, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention.attention(xh, xh, xh, 0.1)
    assert (fused_attention.STATS.launches, fused_attention.HEADED_STATS.launches) == before


@pytest.mark.parametrize("d", [16, 32, 128])
def test_packed_attention_kernel_other_head_dims(cuda, d):
    """K2 at the head dims beside HuBERT's 64, on views of a fused qkv."""
    from quickvc_tpu_torch.ops import fused_attention

    qkv = torch.randn(2, 61, 3 * 4 * d, device=cuda, generator=_gen(cuda, d))
    q, k, v = qkv.chunk(3, dim=-1)
    torch.testing.assert_close(
        fused_attention.attention_packed(q, k, v, 4, d ** -0.5),
        fused_attention.attention_packed_reference(q, k, v, 4, d ** -0.5), atol=1e-4, rtol=1e-3)


def test_packed_aligned_attention_kernel(cuda):
    """K9: heads of true width 40 zero-padded to 128 lanes; padded output lanes are 0."""
    from quickvc_tpu_torch.ops import fused_attention

    b, t_len, h, d = 2, 45, 3, 40
    g = _gen(cuda, 9)
    q, k, v = (torch.nn.functional.pad(torch.randn(b, t_len, h, d, device=cuda, generator=g),
                                       (0, 128 - d)).reshape(b, t_len, h * 128)
               for _ in range(3))
    before = fused_attention.ALIGNED_STATS.launches
    ours = fused_attention.attention_packed_aligned(q, k, v, h, d ** -0.5)
    assert fused_attention.ALIGNED_STATS.launches == before + 1
    torch.testing.assert_close(
        ours, fused_attention.attention_packed_aligned_reference(q, k, v, h, d ** -0.5),
        atol=1e-4, rtol=1e-3)
    assert not ours.reshape(b, t_len, h, 128)[..., d:].any()


@pytest.mark.parametrize("tile", ["128x256", "128x128"])
def test_int8_mm_kernel(cuda, tile):
    """K11 with ragged M and N: int8 exact, bf16 atol 2e-3 / rtol 1e-4 with
    no B^T pre-pass. (1000, 264) is fewer tiles than the card has SMs (one
    block a tile); (2200, 2056) is 18 x 9 or 18 x 17 tiles, more than the
    SMs (several tiles a block, the last raster group of 2 tile rows)."""
    from quickvc_tpu_torch.ops import int8_mm
    from quickvc_tpu_torch.scripts.kernel_times import device_kernels

    g = _gen(cuda, 11)
    for m, n in ((1000, 264), (2200, 2056)):
        a8 = torch.randint(-127, 128, (m, 512), device=cuda, dtype=torch.int8, generator=g)
        b8 = torch.randint(-127, 128, (512, n), device=cuda, dtype=torch.int8, generator=g)
        before = (int8_mm.S8_STATS.launches, int8_mm.BF16_STATS.launches)
        assert torch.equal(int8_mm.mm_kernel(a8, b8, tile), int8_mm.mm_reference(a8, b8))
        abf, bbf = ((x.float() / 127).bfloat16() for x in (a8, b8))
        torch.testing.assert_close(int8_mm.mm_kernel(abf, bbf, tile),
                                   int8_mm.mm_reference(abf, bbf), atol=2e-3, rtol=1e-4)
        assert (int8_mm.S8_STATS.launches, int8_mm.BF16_STATS.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    names = device_kernels(lambda: int8_mm.mm_kernel(abf, bbf, tile))
    assert any("mm_wgmma_kernel" in k for k in names)
    assert not any("transpose_kernel" in k for k in names), names


@pytest.mark.parametrize("tile", ["128x256", "128x128"])
def test_int8_mm_kernel_partial_stage(cuda, tile):
    """K whose bytes are not a multiple of the 128-byte stage (TMA fills the
    rest with zeros), with M and N ragged against the tile; the s8 B^T
    pre-pass, and bf16 reading B as it lies (no pre-pass launched)."""
    from quickvc_tpu_torch.ops import int8_mm
    from quickvc_tpu_torch.scripts.kernel_times import device_kernels

    g = _gen(cuda, 12)
    for m, k, n in ((200, 192, 72), (130, 64, 8)):
        a8 = torch.randint(-127, 128, (m, k), device=cuda, dtype=torch.int8, generator=g)
        b8 = torch.randint(-127, 128, (k, n), device=cuda, dtype=torch.int8, generator=g)
        assert torch.equal(int8_mm.transpose_b(b8), b8.T.contiguous())
        assert torch.equal(int8_mm.mm_kernel(a8, b8, tile), int8_mm.mm_reference(a8, b8))
        abf, bbf = ((x[:, : k // 2].float() / 127).bfloat16() for x in (a8, b8.T))
        bbf = bbf.T.contiguous()                       # K = 96 or 32: 192 or 64 bytes
        torch.testing.assert_close(int8_mm.mm_kernel(abf, bbf, tile),
                                   int8_mm.mm_reference(abf, bbf), atol=2e-3, rtol=1e-4)
        names = device_kernels(lambda: int8_mm.mm_kernel(abf, bbf, tile))
        assert not any("transpose_kernel" in k for k in names), names


def _tiny_generator():
    """A seeded tiny SynthesizerTrn and d-vectors (the CPU tests' TINY_MODEL)."""
    from quickvc_tpu_torch.config import ModelConfig
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import init_random_

    mc = ModelConfig(inter_channels=16, hidden_channels=16, upsample_initial_channel=32,
                     gin_channels=16, unit_channels=24, resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), enc_wn_layers=3,
                     flow_wn_layers=2, n_flows=2)
    net = init_random_(SynthesizerTrn(33, 8, mc), 31).eval()
    g = torch.randn(2, 16, generator=torch.Generator().manual_seed(32))
    return net, g / g.norm(dim=1, keepdim=True)


def test_streaming_and_session_on_card_match_cpu(cuda):
    """streaming_infer and a unit session on the card (K3 per window and per
    tick) against the CPU's plain path, within 1e-3 x peak (the conversion's
    card-against-CPU gate)."""
    import copy

    import numpy as np

    from quickvc_tpu_torch.infer import RealtimeSession, streaming_infer
    from quickvc_tpu_torch.ops import fused_istft

    net, g = _tiny_generator()
    net_card = copy.deepcopy(net).to(cuda)
    unit = torch.randn(2, 24, 150, generator=torch.Generator().manual_seed(33))
    with torch.inference_mode():
        cpu = streaming_infer(net, unit, g, chunk=40, context=32)
        before = fused_istft.STATS.launches
        card = streaming_infer(net_card, unit.to(cuda), g.to(cuda), chunk=40, context=32)
        assert fused_istft.STATS.launches == before + 4
    assert (card.cpu() - cpu).abs().max() <= 1e-3 * cpu.abs().max()

    blocks = unit.transpose(1, 2).numpy()
    outs = {}
    for name, model, dev in (("cpu", net, "cpu"), ("card", net_card, "cuda")):
        session = RealtimeSession(model, g.numpy(), chunk=16, left=32, right=16, device=dev)
        before = fused_istft.STATS.launches
        outs[name] = np.concatenate([session.push(blocks[:, i : i + 16])
                                     for i in range(0, 144, 16)] + [session.flush()], axis=1)
        ticks = fused_istft.STATS.launches - before
        assert ticks == (10 if dev == "cuda" else 0)
    assert np.abs(outs["card"] - outs["cpu"]).max() <= 1e-3 * np.abs(outs["cpu"]).max()
