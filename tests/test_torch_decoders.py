"""PyTorch port, the multiband and single-band iSTFT decoders with the
sub-band STFT loss, against the JAX package.

The decoders at ``tests/test_reference_parity.py``'s small widths (inter 16,
one ResBlock kernel 3 with dilations 1/3/5, upsampling [5, 4] from 32
channels with kernels 16, n_fft 16 / hop 4, 4 bands, gin 16), in inference
(the head through the K3 dispatcher, its plain version on the CPU) and
differentiable (the plain head) modes; the PQMF bank; the centred magnitude
STFT at the three shipped resolutions; the sub-band loss and its gradient
against ``jax.grad``; ``SynthesizerTrn.infer``; a reference-layout
checkpoint of each decoder loading strictly; and the decoders handing their
heads to the K3 dispatcher at inference.

Tolerances: modules atol 1e-4 / rtol 1e-3 (``tests/test_torch_models.py``),
waveforms max-abs <= 1e-3 x max|ref|, the loss and its gradient atol 1e-5 /
rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import t, tiny_generator

SMALL = dict(resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))
# the single-band decoder at 320 samples a unit frame (80 head frames of hop 4),
# which streaming and the live sessions need
SB320 = dict(upsample_rates=(10, 8), upsample_kernel_sizes=(20, 16))
RESOLUTIONS = [(384, 30, 150), (683, 60, 300), (171, 10, 60)]   # configs/quickvc.json:17-19
DECODERS = ["mb", "istft"]


@pytest.fixture(scope="module")
def gens():
    return {d: tiny_generator(seed=3, decoder=d, **SMALL) for d in DECODERS}


@pytest.fixture(scope="module")
def rate_gens():
    """Each new decoder at 320 output samples a unit frame."""
    return {"mb": tiny_generator(seed=8, decoder="mb", **SMALL),
            "istft": tiny_generator(seed=9, decoder="istft", **SMALL, **SB320)}


def _close(ours: torch.Tensor, golden, atol=1e-4, rtol=1e-3):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(golden), atol=atol, rtol=rtol)


def _wave_close(ours: np.ndarray, golden: np.ndarray):
    assert ours.shape == golden.shape
    assert np.abs(ours - golden).max() <= 1e-3 * np.abs(golden).max()


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("decoder", DECODERS)
def test_decoder_matches_jax(gens, rng, decoder, differentiable):
    from quickvc_tpu.models.decoders import build_decoder

    net, params, port = gens[decoder]
    m = net.model
    z = rng.standard_normal((2, 13, m.inter_channels)).astype(np.float32)
    g = rng.standard_normal((2, 1, m.gin_channels)).astype(np.float32)
    dec = build_decoder(m)
    wave, second = jax.jit(lambda p, z, g: dec.apply({"params": p}, z, g))(
        params["dec"], jnp.asarray(z), jnp.asarray(g))
    with torch.set_grad_enabled(differentiable):
        owave, osecond = port.dec(t(z.transpose(0, 2, 1)), t(g.transpose(0, 2, 1)),
                                  differentiable=differentiable)
    _wave_close(owave.detach()[:, 0].numpy(), np.asarray(wave)[..., 0])
    if decoder == "mb":
        assert owave.shape == (2, 1, 13 * 320) and osecond.shape == (2, 4, 13 * 80)
        _wave_close(osecond.detach().numpy(), np.asarray(second).transpose(0, 2, 1))
    else:   # 20 head frames a unit frame, 4 more from the padding, 4 samples each
        assert owave.shape == (2, 1, 4 * (20 * 13 + 4)) and osecond is None and second is None


def test_pqmf_matches_jax(rng):
    from quickvc_tpu.dsp.pqmf import PQMFBank
    from quickvc_tpu_torch.dsp import pqmf

    bank = PQMFBank(4)
    x = rng.standard_normal((2, 2560, 1)).astype(np.float32)
    bands = bank.analysis(jnp.asarray(x))
    ours = pqmf.analysis(t(x.transpose(0, 2, 1)), 4)
    assert ours.shape == (2, 4, 640)
    _close(ours, np.asarray(bands).transpose(0, 2, 1), atol=1e-5, rtol=1e-4)
    y = rng.standard_normal((2, 333, 4)).astype(np.float32)
    golden = bank.synthesis(jnp.asarray(y))
    ours = pqmf.synthesis(t(y.transpose(0, 2, 1)))
    assert ours.shape == (2, 1, 4 * 333)
    _close(ours, np.asarray(golden).transpose(0, 2, 1), atol=1e-5, rtol=1e-4)
    # the filters themselves are the JAX design, to the bit
    from quickvc_tpu.dsp.pqmf import _modulated_filters

    for a, b in zip(pqmf.modulated_filters(4), _modulated_filters(4, 62, 0.15, 9.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_magnitude_stft_matches_jax(rng, n_fft, hop, win):
    from quickvc_tpu.dsp.stft import magnitude_stft as jax_magnitude_stft
    from quickvc_tpu_torch.dsp.stft import magnitude_stft

    y = (0.3 * rng.standard_normal((3, 640))).astype(np.float32)
    golden = np.asarray(jax_magnitude_stft(jnp.asarray(y), n_fft, hop, win))
    ours = magnitude_stft(t(y), n_fft, hop, win)
    frames = 1 + (640 + 2 * (n_fft // 2) - n_fft) // hop   # an odd n_fft frames one sample less
    assert ours.shape == golden.shape == (3, frames, n_fft // 2 + 1)
    _close(ours, golden, atol=1e-5, rtol=1e-4)


def test_subband_stft_loss_and_gradient_match_jax(rng):
    """Value and gradient against ``jax.value_and_grad``: both sides in
    float64 within atol 1e-5 / rtol 1e-4; in float32 the value the same way,
    and the port's gradient no further from JAX's float64 one than JAX's own
    float32 gradient is (1/|z| of the log-magnitude term amplifies float32
    rounding at small magnitudes, on both sides alike)."""
    from quickvc_tpu.losses import subband_stft_loss as jax_loss
    from quickvc_tpu_torch.losses import subband_stft_loss

    sizes = tuple(zip(*RESOLUTIONS))
    y_mb = (0.2 * rng.standard_normal((2, 640, 4))).astype(np.float32)
    y_hat = (0.2 * rng.standard_normal((2, 643, 4))).astype(np.float32)   # cropped to 640

    def golden(dtype):   # one compile a dtype (op by op it took ~20 s of one core)
        value, grad = jax.jit(jax.value_and_grad(lambda y, yh: jax_loss(y, yh, *sizes),
                                                 argnums=1))(jnp.asarray(y_mb, dtype),
                                                             jnp.asarray(y_hat, dtype))
        return float(value), np.asarray(grad).transpose(0, 2, 1)

    def ours(dtype):
        yh = torch.tensor(y_hat.transpose(0, 2, 1), dtype=dtype, requires_grad=True)
        loss = subband_stft_loss(torch.tensor(y_mb.transpose(0, 2, 1), dtype=dtype), yh, *sizes)
        loss.backward()
        assert loss.dtype == dtype and float(yh.grad[..., 640:].abs().max()) == 0.0
        return float(loss.detach()), yh.grad.numpy()

    with jax.enable_x64():
        value64, grad64 = golden(jnp.float64)
    ours64, ograd64 = ours(torch.float64)
    np.testing.assert_allclose(ours64, value64, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ograd64, grad64, atol=1e-5, rtol=1e-4)
    value32, grad32 = golden(jnp.float32)
    ours32, ograd32 = ours(torch.float32)
    np.testing.assert_allclose(ours32, value32, atol=1e-5, rtol=1e-4)
    assert np.abs(ograd32 - grad64).max() <= np.abs(grad32 - grad64).max()


def test_subband_stft_loss_on_digital_silence_matches_jax(rng):
    """A target whose bands are all zero over a whole STFT window: the log of
    its magnitude has no floor in the JAX package, so the loss is +inf there,
    and the port's is too (the training step's guard then skips the update)."""
    from quickvc_tpu.losses import subband_stft_loss as jax_loss
    from quickvc_tpu_torch.losses import subband_stft_loss

    sizes = tuple(zip(*RESOLUTIONS))
    y_mb = (0.2 * rng.standard_normal((1, 640, 4))).astype(np.float32)
    y_mb[:, 100:800] = 0.0
    y_hat = (0.2 * rng.standard_normal((1, 640, 4))).astype(np.float32)
    golden = float(jax.jit(lambda y, yh: jax_loss(y, yh, *sizes))(jnp.asarray(y_mb),
                                                                   jnp.asarray(y_hat)))
    ours = float(subband_stft_loss(t(y_mb.transpose(0, 2, 1)), t(y_hat.transpose(0, 2, 1)),
                                   *sizes))
    assert golden == ours == float("inf")


@pytest.mark.parametrize("decoder", DECODERS)
def test_infer_matches_jax(gens, rng, decoder):
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth

    net, params, port = gens[decoder]
    m = net.model
    unit = rng.standard_normal((2, 30, m.unit_channels)).astype(np.float32)
    g = rng.standard_normal((2, m.gin_channels)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    infer = jax.jit(lambda p, u, gv: net.apply({"params": p}, u, gv, 0.0,
                                                method=JaxSynth.infer))
    golden = np.asarray(infer(params, jnp.asarray(unit), jnp.asarray(g)))[..., 0]
    with torch.no_grad():
        ours = port.infer(t(unit.transpose(0, 2, 1)), t(g), noise_scale=0.0)
    _wave_close(ours[:, 0].numpy(), golden)


@pytest.mark.parametrize("decoder", DECODERS)
def test_reference_checkpoint_loads_strictly(gens, tmp_path, decoder):
    """A reference-layout G_*.pth of each decoder (the JAX package's exporter,
    plus the constant buffers a reference decoder may carry: an iSTFT window
    and a PQMF module's filters) loads strictly and equals the port's mapping
    of the same parameters."""
    from quickvc_tpu.utils.torch_export import export_generator, save_reference_checkpoint
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import load_generator

    net, params, port = gens[decoder]
    sd = export_generator(params, net.model)
    assert ("dec.conv_post.weight_v" in sd) == (decoder == "istft")
    assert not any(k.startswith("dec.multistream_conv_post") for k in sd)
    sd["dec.stft.window"] = torch.hann_window(16).numpy()
    if decoder == "mb":
        sd["dec.pqmf.analysis_filter"] = np.zeros((4, 1, 63), np.float32)
        sd["dec.pqmf.synthesis_filter"] = np.zeros((1, 4, 63), np.float32)
        sd["dec.pqmf.updown_filter"] = np.zeros((4, 4, 4), np.float32)
    path = str(tmp_path / "G_0.pth")
    save_reference_checkpoint(path, sd, iteration=0, learning_rate=2e-4)
    with torch.device("meta"):
        fresh = SynthesizerTrn(33, 8, port.model_cfg)
    load_generator(path, fresh)
    expected = port.state_dict()
    assert fresh.state_dict().keys() == expected.keys()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, expected[k]), k


@pytest.mark.parametrize("decoder,rows", [("mb", 2 * 4), ("istft", 2)])
def test_inference_hands_the_head_to_k3(gens, rng, monkeypatch, decoder, rows):
    """At inference each new head goes through the K3 dispatcher (which on a
    CUDA tensor launches the kernel or raises), with the bands as its rows
    and n_fft 16 / hop 4; in training the plain head runs instead."""
    from quickvc_tpu_torch.models import decoders

    calls = []
    real = decoders.polar_inverse_stft

    def spy(log_mag, phase, n_fft, hop):
        calls.append((tuple(log_mag.shape), n_fft, hop))
        return real(log_mag, phase, n_fft, hop)

    monkeypatch.setattr(decoders, "polar_inverse_stft", spy)
    _, _, port = gens[decoder]
    z = t(rng.standard_normal((2, 16, 11)).astype(np.float32))
    g = t(rng.standard_normal((2, 16, 1)).astype(np.float32))
    with torch.no_grad():
        port.dec(z, g, differentiable=False)
    frames = 20 * 11 + (1 if decoder == "mb" else 5)
    assert calls == [((rows, frames, 9), 16, 4)]
    port.dec(z, g, differentiable=True)
    assert len(calls) == 1


@pytest.mark.parametrize("decoder", DECODERS)
def test_streaming_matches_jax(rate_gens, rng, decoder):
    """``streaming_infer`` with each new decoder against the JAX package's
    (noise 0; the whole output within 1e-4 x its peak, as
    ``tests/test_torch_streaming.py`` holds the multistream one)."""
    from quickvc_tpu.infer import streaming_infer as jax_streaming_infer
    from quickvc_tpu_torch.infer import streaming_infer

    net, params, port = rate_gens[decoder]
    m = net.model
    assert port.dec.samples_per_frame == 320
    unit = rng.standard_normal((2, 77, m.unit_channels)).astype(np.float32)
    g = rng.standard_normal((2, m.gin_channels)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    golden = np.asarray(jax_streaming_infer(net, params, jnp.asarray(unit), jnp.asarray(g),
                                            hop_length=320, chunk=32, context=16))
    with torch.no_grad():
        ours = streaming_infer(port, t(unit.transpose(0, 2, 1)), t(g), hop_length=320,
                               chunk=32, context=16).numpy()
    assert ours.shape == golden.shape == (2, 77 * 320)
    assert np.abs(ours - golden).max() <= 1e-4 * np.abs(golden).max()


@pytest.mark.parametrize("decoder", DECODERS)
def test_unit_session_matches_jax(rate_gens, rng, decoder):
    """A two-stream live session (chunk 16, left 32, right 16) with each new
    decoder against the JAX package's, push by push and the flush, each
    block within 1e-4 x its peak (``tests/test_torch_realtime.py``'s rule)."""
    from quickvc_tpu.infer import RealtimeSession as JaxSession
    from quickvc_tpu_torch.infer import RealtimeSession

    net, params, port = rate_gens[decoder]
    m = net.model
    g = rng.standard_normal((2, m.gin_channels)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    unit = rng.standard_normal((2, 48, m.unit_channels)).astype(np.float32)
    kw = dict(chunk=16, left=32, right=16)
    sessions = (RealtimeSession(port, g, device="cpu", **kw),
                JaxSession(net, params, jnp.asarray(g), **kw))
    ours, golden = ([s.push(unit[:, i : i + 16]) for i in range(0, 48, 16)] + [s.flush()]
                    for s in sessions)
    assert len(ours) == len(golden) == 4
    for a, b in zip(ours, golden):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_streaming_refuses_a_decoder_off_the_hop(gens, rng):
    """The single-band decoder at upsample_rates [5, 4] writes 80 samples a
    unit frame: windows cut at the 320-sample hop would be misaligned, so
    streaming and the live sessions refuse it (batch ``infer`` runs it)."""
    from quickvc_tpu_torch.infer import RealtimeSession, streaming_infer

    _, _, port = gens["istft"]
    assert port.dec.samples_per_frame == 80
    unit = t(rng.standard_normal((1, 24, 40)).astype(np.float32))
    g = t(rng.standard_normal((1, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="80 samples a unit frame"):
        streaming_infer(port, unit, g, hop_length=320, chunk=16, context=8)
    with pytest.raises(ValueError, match="80 samples a unit frame"):
        RealtimeSession(port, g.numpy(), device="cpu")


def test_single_band_step_matches_jax():
    """The training step with the single-band decoder (at 320 samples a unit
    frame) against the JAX step, under the whole-step rules of
    ``tests/test_torch_train_step.py``: the decoder's second output is None
    and the sub-band loss stays zero."""
    from torch_train_support import check_step_parity, jax_step, port_step

    model = dict(ms_istft_vits=False, istft_vits=True, upsample_rates=[10, 8],
                 upsample_kernel_sizes=[20, 16])
    case = jax_step(compact=False, model=model)
    ours = port_step(case)
    assert float(ours[2]["loss/g/subband"]) == float(case["metrics"]["loss/g/subband"]) == 0.0
    assert "dec.conv_post.weight_v" in ours[2]["debug/g_grads"]
    check_step_parity(case, ours)
