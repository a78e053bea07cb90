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
DFT), and on a second card that is not the current device, the k=5 conv and its
gradients atol 1e-4 / rtol 1e-3 (also at the five period discriminators'
full-width shapes, and bit-equal from one launch to the next), the
extractor front atol 5e-4 / rtol 1e-3 (the JAX gate), the transformer layer and the K9/K10 attention layouts atol
1e-4 / rtol 1e-3 (the extractor front and the layer also bit-equal from one
launch to the next), the int8 GEMM exact and its bf16 form atol 2e-3 / rtol
1e-4, streaming and a live session on the card within 1e-3 x peak of the CPU;
K2's bf16 mode within 8e-3 max|v| of its plain version, its error against
float64 attention at most 1.5x the plain version's; the bf16 modes of K7,
K8, K9 and K10 within 1e-2 max|plain| (or two bf16 ulps of it) of their
plain versions, each kernel's error against its float32 kernel on the same
bf16-valued inputs at most 1.5x the plain version's; and so are K5's and
K6's bf16 modes (y, dx, dW), bit-equal from one launch to the next, on both
bodies (the TMA + wgmma body at the period shapes, R = 1-3, every tile width
and K6 split 2 and 3 ways; the mma.sync body at the odd and offset shapes),
K8's
bf16 mode on the wgmma core, and the speaker LSTM's bf16 recurrence kernels
(forward h, act and c, backward dgates; the float32 recurrence the
yardstick), bit-equal from one launch to the next, alone and in a bf16
speaker encoder. The trainer with ``--deterministic`` on the card, at
float32 and at bf16: 4 straight steps and 2 + a resume in a new process + 2
write the same ``G_4.pth`` / ``D_4.pth`` bytes.
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


def test_wave_to_spec_halo_kernel_on_a_card_that_is_not_current(cuda):
    """K4 on cuda:1 while cuda:0 is the current device: the dispatcher enters
    the tensor's card, so the launch lands where its pointers live."""
    from quickvc_tpu_torch.dsp.stft import wave_to_spec_halo as plain
    from quickvc_tpu_torch.ops import fused_mel

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (one card is always the current device)")
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        y = 0.3 * torch.randn(3, 37 * 320 + 960, device=other, generator=_gen(other, 2))
        ours = fused_mel.wave_to_spec_halo(y, 1280, 320, 1280)
        assert torch.cuda.current_device() == 0
    assert ours.device == other
    torch.testing.assert_close(ours, plain(y, 1280, 320, 1280), atol=2e-4, rtol=2e-4)


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


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape,offset", [((3, 37, 24, 40), False), ((6, 64, 256, 128), False),
                                          ((5, 13, 30, 42), False), ((4, 12, 33, 17), False),
                                          ((6, 64, 256, 128), True)]
                         + [(s, False) for s in PERIOD_SHAPES[::4]])
def test_conv5_lrelu_bf16_kernels(cuda, shape, offset):
    """K5/K6 in their bf16 mode through the autograd.Function: y, dx, dW and
    db in bf16, each against its plain version on the same bf16 inputs and
    dym (the bf16 gates: within 1e-2 max|plain| or two bf16 ulps of it, the
    error against the float32 kernel on the bf16-valued inputs at most 1.5x
    the plain version's); launches counted in the bf16 stats only; a second
    launch of each bit-equal. Channels that are not multiples of 8 take the
    gathered copies, and so does x 2 bytes past a 16-byte boundary
    (``offset``); the period shapes run the TMA + wgmma body."""
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    n, rows, c_in, c_out = shape
    bf = torch.bfloat16
    g = _gen(cuda, c_in + 1)
    x = torch.randn(n, rows, c_in, device=cuda, generator=g).to(bf)
    k = (torch.randn(5, c_in, c_out, device=cuda, generator=g) / (5 * c_in) ** 0.5).to(bf)
    b = (0.1 * torch.randn(c_out, device=cuda, generator=g)).to(bf)
    dy = (torch.randn(n, rows, c_out, device=cuda, generator=g) / (n * rows) ** 0.5).to(bf)
    if offset:
        x = _offset_view(x)
    ins = [t.detach().requires_grad_() for t in (x, k, b)]   # x keeps its offset
    counts = (fdc.STATS.launches, fdc.DW_STATS.launches, fdc.BF16_STATS.launches,
              fdc.DW_BF16_STATS.launches)
    y = fdc.conv5_lrelu(*ins, 0.1)
    y.backward(dy)
    assert (fdc.STATS.launches, fdc.DW_STATS.launches, fdc.BF16_STATS.launches,
            fdc.DW_BF16_STATS.launches) == (counts[0], counts[1], counts[2] + 2, counts[3] + 1)
    assert all(t.grad.dtype == bf for t in ins)
    _bf16_gates(y, fdc.conv5_lrelu_reference_bf16(x, k, b, 0.1),
                fdc.conv5_lrelu_kernel(x.float(), k.float(), b.float(), 0.1))
    dym = (dy * torch.where(y > 0, 1.0, 0.1).to(bf)).contiguous()
    k_flip = k.flip(0).transpose(1, 2).contiguous()
    _bf16_gates(ins[0].grad, fdc.conv5_lrelu_reference_bf16(dym, k_flip, None, 1.0),
                fdc.conv5_lrelu_kernel(dym.float(), k_flip.float(), None, 1.0))
    _bf16_gates(ins[1].grad, fdc.conv5_dw_reference(x, dym),
                fdc.conv5_dw_kernel(x.float(), dym.float()))
    assert torch.equal(ins[2].grad, dym.float().sum(dim=(0, 1)).to(bf))
    assert torch.equal(fdc.conv5_lrelu_kernel(x, k, b, 0.1), y.detach())
    assert torch.equal(fdc.conv5_dw_kernel(x, dym), ins[1].grad)


# shapes of the wgmma body of K5/K6 bf16 beyond the period shapes: R = 1, 2
# and 3 (a row's shifts cross an item edge on both sides), C_out off the
# tile width (its dx on the mma.sync body), C_in 64 (K6's last tile half past
# 5 C_in)
WGMMA_SHAPES = [(96, 1, 128, 72), (70, 2, 256, 200), (45, 3, 64, 1024)]


def _conv5_bf16_inputs(dev, shape, seed):
    """x, filter, bias and dym (as the backward forms it from y) in bf16,
    scaled so that y, dx and dW are O(1)."""
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    n, rows, c_in, c_out = shape
    bf = torch.bfloat16
    g = _gen(dev, seed)
    x = torch.randn(n, rows, c_in, device=dev, generator=g).to(bf)
    k = (torch.randn(5, c_in, c_out, device=dev, generator=g) / (5 * c_in) ** 0.5).to(bf)
    b = (0.1 * torch.randn(c_out, device=dev, generator=g)).to(bf)
    dy = (torch.randn(n, rows, c_out, device=dev, generator=g) / (n * rows) ** 0.5).to(bf)
    y = fdc.conv5_lrelu_reference_bf16(x, k, b, 0.1)
    dym = (dy * torch.where(y > 0, 1.0, 0.1).to(bf)).contiguous()
    return x, k, b, dym


@pytest.mark.parametrize("shape,offset", [(s, False) for s in PERIOD_SHAPES + WGMMA_SHAPES]
                         + [((5, 13, 30, 42), False), ((4, 12, 33, 17), False),
                            ((6, 64, 256, 128), True)])
def test_conv5_bf16_bodies(cuda, shape, offset):
    """K5 bf16 (y, dx) and K6 bf16 (dW) through their wrappers, each on the
    body the host picks by shape: the TMA + wgmma body where C_in is a
    multiple of 64, C_out of 8 and the tensors 16-byte aligned (every period
    shape, R = 1, 2, 3), the mma.sync body otherwise (channels off multiples
    of 8, x 2 bytes past a 16-byte boundary). Each against its plain version
    by the bf16 gates; the wgmma body's counters move for its launches only,
    the bf16 counters for every one; a second launch bit-equal."""
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    n, rows, c_in, c_out = shape
    x, k, b, dym = _conv5_bf16_inputs(cuda, shape, 7 * c_in + rows)
    if offset:
        x = _offset_view(x)
    k_flip = k.flip(0).transpose(1, 2).contiguous()
    on_wgmma = (fdc.takes_wgmma(c_in, c_out, x, k, b), fdc.takes_wgmma(c_out, c_in, dym, k_flip),
                fdc.takes_wgmma(c_in, c_out, x, dym))
    if offset:   # dx reads dym and the flipped filter, both aligned
        assert on_wgmma == (False, True, False)
    elif shape in PERIOD_SHAPES + WGMMA_SHAPES:   # dx's C_in is C_out
        assert on_wgmma == (True, c_out % 64 == 0, True)
    else:
        assert on_wgmma == (False, False, False)
    stats = (fdc.BF16_STATS, fdc.DW_BF16_STATS, fdc.WGMMA_STATS, fdc.DW_WGMMA_STATS)
    before = [s.launches for s in stats]
    y = fdc.conv5_lrelu_kernel(x, k, b, 0.1)
    dx = fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0)
    dw = fdc.conv5_dw_kernel(x, dym)
    assert [s.launches - b0 for s, b0 in zip(stats, before)] == [
        2, 1, on_wgmma[0] + on_wgmma[1], on_wgmma[2]]
    _bf16_gates(y, fdc.conv5_lrelu_reference_bf16(x, k, b, 0.1),
                fdc.conv5_lrelu_kernel(x.float(), k.float(), b.float(), 0.1))
    _bf16_gates(dx, fdc.conv5_lrelu_reference_bf16(dym, k_flip, None, 1.0),
                fdc.conv5_lrelu_kernel(dym.float(), k_flip.float(), None, 1.0))
    _bf16_gates(dw, fdc.conv5_dw_reference(x, dym), fdc.conv5_dw_kernel(x.float(), dym.float()))
    assert torch.equal(fdc.conv5_lrelu_kernel(x, k, b, 0.1), y)
    assert torch.equal(fdc.conv5_lrelu_kernel(dym, k_flip, None, 1.0), dx)
    assert torch.equal(fdc.conv5_dw_kernel(x, dym), dw)


@pytest.mark.parametrize("bn", [64, 128, 192, 256])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_conv5_bf16_wgmma_every_tile_and_split(cuda, monkeypatch, bn, splits):
    """Every compiled tile width of the wgmma body, and K6 split 2 and 3 ways
    (the plan splits no period shape), at (37, 19, 128, 192): 703 rows,
    ragged against every tile, K6's reduction 11 k tiles, its last split
    ragged. Held against the plain versions by the bf16 gates; a second
    launch bit-equal."""
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc
    from quickvc_tpu_torch.ops.fused_transformer import WgmmaPlan

    shape = (37, 19, 128, 192)
    n, rows, c_in, c_out = shape
    x, k, b, dym = _conv5_bf16_inputs(cuda, shape, bn + splits)
    k_tiles = -(-n * rows // 64)
    per = -(-k_tiles // splits)

    def plan(dw, *dims, **kw):
        if not dw:
            return WgmmaPlan(bn, 1, 5 * c_in, 0)
        return WgmmaPlan(bn, splits, per * 64, splits * 5 * c_in * c_out if splits > 1 else 0)

    monkeypatch.setattr(fdc, "conv5_wgmma_plan", plan)
    before = (fdc.WGMMA_STATS.launches, fdc.DW_WGMMA_STATS.launches)
    y = fdc.conv5_lrelu_kernel(x, k, b, 0.1)
    dw = fdc.conv5_dw_kernel(x, dym)
    assert (fdc.WGMMA_STATS.launches, fdc.DW_WGMMA_STATS.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    _bf16_gates(y, fdc.conv5_lrelu_reference_bf16(x, k, b, 0.1),
                fdc.conv5_lrelu_kernel(x.float(), k.float(), b.float(), 0.1))
    _bf16_gates(dw, fdc.conv5_dw_reference(x, dym), fdc.conv5_dw_kernel(x.float(), dym.float()))
    assert torch.equal(fdc.conv5_lrelu_kernel(x, k, b, 0.1), y)
    assert torch.equal(fdc.conv5_dw_kernel(x, dym), dw)


def test_conv5_bf16_wgmma_attributes(cuda):
    """Each compiled wgmma body of K5/K6 bf16 fits one block an SM, spills
    nothing and reads its dynamic shared memory."""
    from quickvc_tpu_torch.ops import fused_disc_conv as fdc

    for dw in (False, True):
        for bn in (64, 128, 192, 256):
            attr = fdc.conv5_wgmma_attributes(dw, bn)
            assert attr["blocks_per_sm"] == 1 and attr["local_bytes"] == 0, (dw, bn, attr)


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
    with pytest.raises(TypeError, match="one dtype"):
        fa.attention_kernel(q[:, None], q.bfloat16()[:, None], q[:, None], 0.125)


def _bf16_gates(ours, plain, ref32):
    """The bf16 modes' gates (PERF.md section 2)."""
    peak = float(plain.float().abs().max())
    ulp = 2.0 ** (int(torch.tensor(peak).log2().floor()) - 7)
    assert ours.dtype == torch.bfloat16 and bool(torch.isfinite(ours).all())
    assert float((ours.float() - plain.float()).abs().max()) <= max(1e-2 * peak, 2 * ulp)
    err_k, err_p = ((z.float() - ref32.float()).abs().max() for z in (ours, plain))
    assert err_k <= 1.5 * err_p


@pytest.mark.parametrize("shape", [(2, 3, 77, 16), (2, 3, 77, 32), (8, 12, 250, 64),
                                   (2, 3, 77, 128)])
def test_headed_attention_bf16_kernel(cuda, shape):
    """K10's bf16 mode at each compiled head dim, on views of packed rows."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    b, h, t_len, d = shape
    qkv = torch.randn(b, t_len, 3, h, d, device=cuda, generator=_gen(cuda, d)).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = (fa.HEADED_STATS.launches, fa.HEADED_BF16_STATS.launches)
    ours = fa.attention(q, k, v, d ** -0.5)
    assert (fa.HEADED_STATS.launches, fa.HEADED_BF16_STATS.launches) == (before[0],
                                                                         before[1] + 1)
    _bf16_gates(ours, fa.attention_reference(q, k, v, d ** -0.5),
                fa.attention_kernel(q.float(), k.float(), v.float(), d ** -0.5))


@pytest.mark.parametrize("d", [64, 128])
def test_attention_bf16_bodies_on_unaligned_views(cuda, d):
    """Views TMA does not take (rows of D + 1 values, one value in) run the
    mma.sync body, aligned ones the wgmma body: both by the bf16 gates."""
    from quickvc_tpu_torch.ops import fused_attention as fa

    g = _gen(cuda, d + 1)
    wide = [torch.randn(2, 3, 77, d + 1, device=cuda, generator=g).bfloat16() for _ in range(3)]
    for q, k, v in ([z[..., 1:] for z in wide], [z[..., 1:].contiguous() for z in wide]):
        plan = fa.bf16_attention_plan(2, 3, 77, d, tma=fa._tma_ok(
            *((z, z.stride()[:3]) for z in (q, k, v))))
        assert plan.body == ("wgmma" if q.is_contiguous() else "mma_sync")
        _bf16_gates(fa.attention(q, k, v, d ** -0.5), fa.attention_reference(q, k, v, d ** -0.5),
                    fa.attention_kernel(q.float(), k.float(), v.float(), d ** -0.5))


def test_packed_aligned_bf16_kernel(cuda):
    """K9's bf16 mode: 64 true lanes a 128-lane head; padded lanes exactly zero."""
    import torch.nn.functional as F

    from quickvc_tpu_torch.ops import fused_attention as fa

    b, t_len = 3, 250
    q, k, v = (F.pad(torch.randn(b, t_len, 12, 64, device=cuda, generator=_gen(cuda, i)),
                     (0, 64)).reshape(b, t_len, 12 * 128).bfloat16() for i in range(3))
    before = fa.ALIGNED_BF16_STATS.launches
    ours = fa.attention_packed_aligned(q, k, v, 12, 0.125)
    assert fa.ALIGNED_BF16_STATS.launches == before + 1
    assert not ours.reshape(b, t_len, 12, 128)[..., 64:].any()
    _bf16_gates(ours, fa.attention_packed_aligned_reference(q, k, v, 12, 0.125),
                fa.attention_packed_aligned_kernel(q.float(), k.float(), v.float(), 12, 0.125))


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


@pytest.mark.parametrize("shape", [(2, 16003, 128), (3, 32083, 512), (2, 3013, 64),
                                   (1, 1333, 512)])
def test_extractor_front_bf16_kernel(cuda, shape):
    """K7's bf16 mode on a bf16 wave and float32 weights, as the HuBERT hands
    them over; bit-equal from one launch to the next."""
    from quickvc_tpu_torch.ops import fused_extractor as fe

    b, t_len, c = shape
    wav, w0, gamma, beta, w1 = _front_inputs(cuda, b, t_len, c)
    front = (wav.bfloat16(), w0, gamma, beta, w1)
    before = (fe.STATS.launches, fe.BF16_STATS.launches)
    ours = fe.extractor_front(*front)
    assert (fe.STATS.launches, fe.BF16_STATS.launches) == (before[0], before[1] + 1)
    assert ours.shape == (b, fe.front_rows(t_len), c)
    _bf16_gates(ours, fe.extractor_front_reference(*front),
                fe.extractor_front_kernel(wav.bfloat16().float(), w0.bfloat16().float(), gamma,
                                          beta, w1.bfloat16().float()))
    assert torch.equal(ours, fe.extractor_front(*front))


@pytest.mark.parametrize("shape", [(16, 96080), (3, 32083), (1, 1333)])
def test_extractor_front_bf16_wgmma_body(cuda, shape):
    """K7's bf16 mode at HuBERT's width on the TMA + wgmma body: the
    encoding batch's 6-s bucket (2,416 tiles), n1 = 3,207 (an odd tile
    count: a pair's second tile stores nothing) and n1 = 132 (a 4-row
    tile); the bf16 gates against the plain version and the float32
    kernel, and the same bits from two launches."""
    from quickvc_tpu_torch.ops import fused_extractor as fe

    b, t_len = shape
    wav, w0, gamma, beta, w1 = _front_inputs(cuda, b, t_len, 512)
    front = (wav.bfloat16(), w0, gamma, beta, w1)
    before = (fe.BF16_STATS.launches, fe.WGMMA_STATS.launches)
    ours = fe.extractor_front(*front)
    assert (fe.BF16_STATS.launches, fe.WGMMA_STATS.launches) == (before[0] + 1, before[1] + 1)
    assert ours.shape == (b, fe.front_rows(t_len), 512)
    plain = fe.extractor_front_reference(*front)
    ref32 = fe.extractor_front_kernel(wav.bfloat16().float(), w0.bfloat16().float(), gamma, beta,
                                      w1.bfloat16().float())
    _bf16_gates(ours, plain, ref32)
    assert torch.equal(ours, fe.extractor_front(*front))


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


@pytest.mark.parametrize("t_len", [37, 300, 80])
def test_transformer_layer_bf16_kernel(cuda, t_len):
    """K8's bf16 mode at M = 111 and 900 (split and not) and a live window's
    80 rows, against its plain version and the float32 kernel with the weight
    matrices rounded to bf16; bit-equal from one launch to the next."""
    from quickvc_tpu_torch.ops import fused_attention, fused_transformer as ft

    layer = _fused_layer(cuda, t_len)
    layer32 = _fused_layer(cuda, t_len)
    with torch.no_grad():
        for p in layer32.parameters():
            if p.dim() == 2:
                p.copy_(p.bfloat16().float())
    x = torch.randn(3, t_len, 768, device=cuda, generator=_gen(cuda, t_len)).bfloat16()
    before = (ft.STATS.launches, ft.BF16_STATS.launches, fused_attention.BF16_STATS.launches)
    with torch.inference_mode():
        ours = layer(x)
        assert (ft.STATS.launches, ft.BF16_STATS.launches,
                fused_attention.BF16_STATS.launches) == (before[0], before[1] + 1, before[2])
        _bf16_gates(ours, ft.transformer_layer_reference(x, layer),
                    ft.transformer_layer_kernel(x.float(), layer32))
        assert torch.equal(ours, layer(x))


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


@pytest.mark.parametrize("batch,t_len,hidden", [(32, 512, 256), (2, 16, 16), (37, 40, 64)])
def test_lstm_recurrence_kernels(cuda, batch, t_len, hidden):
    """The speaker LSTM's bf16 recurrence kernels at the training batch's
    layer (32, 512, 4 x 256), the small step gate's (2, 16, 4 x 16) and two
    clusters of a ragged batch, forward (h, act, c) and backward (dgates)
    against their plain versions on the card by the bf16 gates, the
    float32 recurrence the yardstick; each bit-equal from one launch to the
    next, and one launch each a call."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    g = _gen(cuda, hidden)
    xp = torch.randn(batch, t_len, 4 * hidden, device=cuda, generator=g).bfloat16()
    w = (torch.randn(4 * hidden, hidden, device=cuda, generator=g) / hidden ** 0.5).bfloat16()
    dh = torch.randn(batch, t_len, hidden, device=cuda, generator=g).bfloat16()
    before = (lr.STATS.launches, lr.BACKWARD_STATS.launches)
    ours = lr.lstm_forward_kernel(xp, w)
    back = lr.lstm_backward_kernel(dh, w, ours[1], ours[2])
    assert (lr.STATS.launches, lr.BACKWARD_STATS.launches) == (before[0] + 1, before[1] + 1)
    plain = lr.lstm_forward_reference(xp, w)
    ref32 = lr.lstm_forward_reference(xp.float(), w.float())
    for o, p, r in zip(ours, plain, ref32):
        _bf16_gates(o, p, r)
    _bf16_gates(back, lr.lstm_backward_reference(dh, w, ours[1], ours[2]),
                lr.lstm_backward_reference(dh.float(), w.float(), ref32[1], ref32[2]))
    assert all(torch.equal(a, b) for a, b in zip(ours, lr.lstm_forward_kernel(xp, w)))
    assert torch.equal(back, lr.lstm_backward_kernel(dh, w, ours[1], ours[2]))


@pytest.mark.parametrize("batch,t_len,hidden,layers", [(32, 512, 256, 3), (37, 40, 64, 3),
                                                        (2, 16, 16, 2), (3, 9, 32, 4)])
def test_lstm_stack_kernel(cuda, batch, t_len, hidden, layers):
    """The forward kernel over a whole stack in one launch (the training
    batch's three layers, two chunks of a ragged batch, the step gate's
    width, four layers) against the plain stack on the card: h, act and c
    of every layer by the bf16 gates, the float32 stack the yardstick; two
    launches bit-equal."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    g = _gen(cuda, hidden + layers)

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=cuda, generator=g)).bfloat16()

    xp = draw(batch, t_len, 4 * hidden)
    w_hh = [draw(4 * hidden, hidden, scale=hidden ** -0.5) for _ in range(layers)]
    w_ih = [draw(4 * hidden, hidden, scale=hidden ** -0.5) for _ in range(layers - 1)]
    b = [draw(4 * hidden, scale=0.1) for _ in range(layers - 1)]
    before = lr.STATS.launches
    ours = lr.lstm_stack_kernel(xp, w_ih, b, w_hh)
    assert lr.STATS.launches == before + 1
    plain = lr.lstm_stack_reference(xp, w_ih, b, w_hh)
    ref32 = lr.lstm_stack_reference(xp.float(), [w.float() for w in w_ih],
                                    [z.float() for z in b], [w.float() for w in w_hh])
    for o, p, r in zip(ours, plain, ref32):
        assert o.shape == p.shape
        for layer in range(layers):
            _bf16_gates(o[layer], p[layer], r[layer])
    assert all(torch.equal(a, z) for a, z in zip(ours, lr.lstm_stack_kernel(xp, w_ih, b, w_hh)))


@pytest.mark.parametrize("batch,t_len,hidden,layers", [(32, 512, 256, 3), (37, 40, 64, 3),
                                                        (2, 16, 16, 2), (3, 9, 32, 4),
                                                        (20, 24, 48, 1)])
def test_lstm_stack_backward_kernel(cuda, batch, t_len, hidden, layers):
    """The backward kernel over a whole stack in one launch (the training
    batch's three layers, three chunks of a ragged batch, the step gate's
    width, four layers, one layer of two chunks), layer by layer on the
    output gradient it handed that layer: each layer's dgates against the
    plain backward on the same inputs by the bf16 gates (the float32
    recurrence the yardstick) and bit-equal to the one-layer kernel on
    them; each handed-down dh within one bf16 ulp, element by element, of
    the float32 product ``dgates @ w_ih`` (plus 2^-16 of the sum of the
    products' magnitudes: two float32 sums in different orders); the whole
    stack's max and rms errors against the float64 stack backward on the
    same bf16-valued inputs at most 1.5 times the plain stack backward's,
    every layer; two launches bit-equal."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    g = _gen(cuda, 3 * hidden + layers)

    def draw(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=cuda, generator=g)).bfloat16()

    xp = draw(batch, t_len, 4 * hidden)
    w_hh = [draw(4 * hidden, hidden, scale=hidden ** -0.5) for _ in range(layers)]
    w_ih = [draw(4 * hidden, hidden, scale=hidden ** -0.5) for _ in range(layers - 1)]
    b = [draw(4 * hidden, scale=0.1) for _ in range(layers - 1)]
    dh = draw(batch, t_len, hidden)
    _, act, c = lr.lstm_stack_kernel(xp, w_ih, b, w_hh)
    before = lr.BACKWARD_STATS.launches
    ours, dh_mid = lr.lstm_stack_backward_kernel(dh, w_ih, w_hh, act, c, return_dh=True)
    assert lr.BACKWARD_STATS.launches == before + 1 and ours.shape == act.shape
    for layer in range(layers):
        dh_l = dh if layer + 1 == layers else dh_mid[layer]
        _bf16_gates(ours[layer], lr.lstm_backward_reference(dh_l, w_hh[layer], act[layer],
                                                            c[layer]),
                    lr.lstm_backward_reference(dh_l.float(), w_hh[layer].float(),
                                               act[layer].float(), c[layer].float()))
        assert torch.equal(ours[layer], lr.lstm_backward_kernel(dh_l, w_hh[layer], act[layer],
                                                                c[layer]))
        if layer:   # one rounding of a float32 sum, in another order than torch's
            want = ours[layer].float() @ w_ih[layer - 1].float()
            scale = ours[layer].float().abs() @ w_ih[layer - 1].float().abs()
            got = dh_mid[layer - 1].float()
            ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()))) - 7)
            assert bool(((got - want).abs() <= ulp + 2.0 ** -16 * scale).all())
    plain = lr.lstm_stack_backward_reference(dh, w_ih, w_hh, act, c)
    ref = lr.lstm_stack_backward_reference(dh.double(), [w.double() for w in w_ih],
                                           [w.double() for w in w_hh], act.double(), c.double())
    for layer in range(layers):
        err_k, err_p = (z[layer].double() - ref[layer] for z in (ours, plain))
        assert float(err_k.abs().max()) <= 1.5 * float(err_p.abs().max())
        assert float(err_k.square().mean()) <= 1.5 ** 2 * float(err_p.square().mean())
    assert torch.equal(ours, lr.lstm_stack_backward_kernel(dh, w_ih, w_hh, act, c))


def test_lstm_stack_backward_refuses_a_launch_the_card_cannot_hold(cuda):
    """Three layers of 640 rows take 120 clusters of 8 CTAs in the backward,
    all resident at once: more than an H100 holds, so the wrapper raises
    and launches nothing."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    act = torch.zeros(3, 32 * 20, 4, 4 * 64, device=cuda, dtype=torch.bfloat16)
    c = torch.zeros(3, 32 * 20, 4, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(4 * 64, 64, device=cuda, dtype=torch.bfloat16)
    before = lr.BACKWARD_STATS.launches
    with pytest.raises(RuntimeError, match="120 clusters"):
        lr.lstm_stack_backward_kernel(c[0], [w, w], [w, w, w], act, c)
    assert lr.BACKWARD_STATS.launches == before


def test_lstm_stack_refuses_a_launch_the_card_cannot_hold(cuda):
    """Three layers of 640 rows take 60 clusters of 8 CTAs, all resident at
    once: more than an H100 holds, so the wrapper raises and launches
    nothing."""
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    z = torch.zeros(32 * 20, 4, 4 * 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(4 * 64, 64, device=cuda, dtype=torch.bfloat16)
    before = lr.STATS.launches
    with pytest.raises(RuntimeError, match="60 clusters"):
        lr.lstm_stack_kernel(z, [w, w], [w[:, 0], w[:, 0]], [w, w, w])
    assert lr.STATS.launches == before


def test_lstm_recurrence_kernels_refuse_what_the_plan_does_not_take(cuda):
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    with pytest.raises(ValueError, match="multiple of 16"):
        lr.lstm_forward_kernel(torch.zeros(2, 4, 4 * 24, device=cuda, dtype=torch.bfloat16),
                               torch.zeros(4 * 24, 24, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="more than the card's"):
        lr.lstm_forward_kernel(torch.zeros(32 * 17, 2, 64, device=cuda, dtype=torch.bfloat16),
                               torch.zeros(64, 16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        lr.lstm_forward_kernel(torch.zeros(2, 4, 64, device=cuda),
                               torch.zeros(64, 16, device=cuda))


def test_speaker_encoder_bf16_runs_the_lstm_kernels(cuda):
    """A bf16 speaker encoder on the card (the small step gate's width):
    one forward launch and one backward launch for the whole stack,
    d-vectors and gradients within the bf16 gates of the plain versions on
    the card."""
    from quickvc_tpu_torch.models.encoders import SpeakerEncoder
    from quickvc_tpu_torch.ops import lstm_recurrence as lr
    from quickvc_tpu_torch.scripts.bf16_step_gate import card_lstm

    torch.manual_seed(5)
    enc = SpeakerEncoder(model_hidden_size=16, model_embedding_size=16).to(cuda)
    mel = torch.randn(2, 16, 80, device=cuda, generator=_gen(cuda, 7)).bfloat16()

    def run():
        enc.zero_grad(set_to_none=True)
        d = enc(mel)
        d.float().square().sum().backward()
        return [d] + [p.grad.bfloat16() for p in enc.lstm.parameters()]

    before = (lr.STATS.launches, lr.BACKWARD_STATS.launches)
    ours = run()
    assert (lr.STATS.launches, lr.BACKWARD_STATS.launches) == (before[0] + 1, before[1] + 1)
    with card_lstm("recurrence"):
        plain = run()
    enc.zero_grad(set_to_none=True)
    d32 = enc(mel.float())
    d32.square().sum().backward()
    ref32 = [d32] + [p.grad for p in enc.lstm.parameters()]
    for o, p, r in zip(ours, plain, ref32):
        _bf16_gates(o, p, r)


@pytest.mark.parametrize("batch", [1, 16])
def test_transformer_layer_bf16_kernel_on_the_wgmma_core(cuda, batch):
    """K8's bf16 mode at (1, 300, 768) (linear2 split) and the encoding
    batch (16, 300, 768): the wgmma core's plans, the bf16 gates, and the
    same bits from two launches."""
    from quickvc_tpu_torch.ops import fused_transformer as ft

    layer = _fused_layer(cuda, 300)
    layer32 = _fused_layer(cuda, 300)
    with torch.no_grad():
        for p in layer32.parameters():
            if p.dim() == 2:
                p.copy_(p.bfloat16().float())
    plans = ft.wgmma_layer_plans(batch * 300, 768, 3072)
    assert any(p.splits > 1 for p in plans) == (batch == 1)
    x = torch.randn(batch, 300, 768, device=cuda, generator=_gen(cuda, batch)).bfloat16()
    with torch.inference_mode():
        ours = ft.transformer_layer(x, layer)
        _bf16_gates(ours, ft.transformer_layer_reference(x, layer),
                    ft.transformer_layer_kernel(x.float(), layer32))
        assert torch.equal(ours, ft.transformer_layer(x, layer))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_deterministic_resume_on_the_card_equals_straight_steps(cuda, tmp_path, precision):
    """``python -m quickvc_tpu_torch.train --deterministic`` (each run a new
    process, so cuBLAS reads its workspace setting at its first handle): 4
    straight steps against 2 steps and a resume to 4, checkpoints byte for
    byte, at a tiny config."""
    import os
    import subprocess
    import sys

    import numpy as np

    from quickvc_tpu_torch.config import config_from_dict
    from test_torch_train_data import write_corpus

    listing = write_corpus(tmp_path / "corpus", np.random.default_rng(4),
                           [0.85, 0.9, 0.95, 1.0, 0.88, 0.92, 0.97, 0.86])
    cfg = config_from_dict({
        "train": {"segment_size": 2560, "max_speclen": 32, "precision": precision,
                  "learning_rate": 1e-4, "disc_width": 0.25, "batch_size": 2,
                  "loader_workers": 2, "log_interval": 1, "eval_interval": 0},
        "model": {"inter_channels": 16, "hidden_channels": 16, "upsample_initial_channel": 32,
                  "gin_channels": 16, "unit_channels": 12, "resblock_kernel_sizes": [3],
                  "resblock_dilation_sizes": [[1, 3, 5]], "enc_wn_layers": 2,
                  "flow_wn_layers": 2, "n_flows": 2}})
    cfg.data.training_files = cfg.data.validation_files = listing
    hpfile = str(tmp_path / "tiny.json")
    cfg.save(hpfile)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, steps in (("resumed", 2), ("resumed", 4), ("straight", 4)):
        subprocess.run([sys.executable, "-m", "quickvc_tpu_torch.train", "-c", hpfile, "-m", name,
                        "-mr", str(tmp_path / "logs"), "--max-steps", str(steps),
                        "--deterministic"], cwd=root, check=True, timeout=600)
    for kind in "GD":
        assert ((tmp_path / "logs" / "resumed" / f"{kind}_4.pth").read_bytes()
                == (tmp_path / "logs" / "straight" / f"{kind}_4.pth").read_bytes()), kind
