"""PyTorch port, host and DSP layers: config, audio I/O, mel and iSTFT plain
versions (kernels K1 and K3) held against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as tests/test_pallas.py
does. Tolerances: log-mel 2e-3, iSTFT head atol 1e-4 / rtol 1e-3.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_support import t

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "quickvc.json")


def _pallas_interpret(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


def test_config_matches_jax(tmp_path):
    import json

    from quickvc_tpu.config import load_config as jax_load
    from quickvc_tpu_torch.config import load_config

    assert load_config(CONFIG).to_dict() == jax_load(CONFIG).to_dict()
    # the pretrained run's legacy keys are accepted and ignored
    with open(CONFIG) as f:
        legacy = json.load(f)
    legacy["model"].update(ssl_dim=256, use_sr=True, n_layers_q=3)
    path = tmp_path / "legacy.json"
    path.write_text(json.dumps(legacy))
    cfg = load_config(str(path))
    assert cfg.to_dict() == jax_load(str(path)).to_dict()
    assert cfg.spec_channels == 641 and cfg.model.decoder_kind == "ms_istft"


def test_audio_io_matches_jax(tmp_path, rng):
    from quickvc_tpu.data import audio_io as jax_io
    from quickvc_tpu_torch.data import audio_io

    x = (rng.standard_normal(22050) * 0.1).astype(np.float32)
    x[:4000] *= 1e-4  # a quiet lead-in to trim
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, x, 22050)
    y, sr = audio_io.read_wav(path)
    assert sr == 22050 and y.dtype == np.float32
    np.testing.assert_array_equal(y, jax_io.read_wav(path)[0])
    np.testing.assert_array_equal(audio_io.resample(y, sr, 16000),
                                  jax_io.resample(y, sr, 16000))
    ours, span = audio_io.trim_silence(y, top_db=20)
    theirs, jspan = jax_io.trim_silence(y, top_db=20)
    assert span == jspan and span[0] > 0
    np.testing.assert_array_equal(ours, theirs)


def test_filterbank_and_window_match_jax():
    from quickvc_tpu.dsp.mel import mel_filterbank as jax_fb
    from quickvc_tpu.dsp.stft import hann_window as jax_hann
    from quickvc_tpu_torch.dsp.mel import mel_filterbank
    from quickvc_tpu_torch.dsp.stft import hann_window

    np.testing.assert_array_equal(mel_filterbank(16000, 1280, 80), jax_fb(16000, 1280, 80))
    np.testing.assert_array_equal(hann_window(1280), jax_hann(1280))
    # torch rounds its window in float32 arithmetic: equal within 2 float32 ulps
    np.testing.assert_allclose(hann_window(16), torch.hann_window(16).numpy(), atol=2.4e-7)


@pytest.mark.parametrize("shape", [(2, 10240), (1, 16003)])
def test_wave_to_mel_plain_matches_pallas(rng, shape):
    """K1's plain version == JAX wave_to_mel_pallas (interpret mode)."""
    from quickvc_tpu.ops.fused_mel import wave_to_mel_pallas
    from quickvc_tpu_torch.ops import fused_mel

    y = rng.standard_normal(shape).astype(np.float32) * 0.4
    golden = np.asarray(_pallas_interpret(
        wave_to_mel_pallas, jnp.asarray(y), 16000, 1280, 320, 1280, 80))
    before = fused_mel.STATS.launches
    ours = fused_mel.wave_to_mel(t(y), 16000, 1280, 320, 1280, 80).numpy()
    assert fused_mel.STATS.launches == before  # CPU tensor: plain path, no kernel
    assert ours.shape == golden.shape == (shape[0], shape[1] // 320, 80)
    np.testing.assert_allclose(ours, golden, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("shape", [(2, 41), (3, 300)])
def test_polar_istft_plain_matches_pallas(rng, shape):
    """K3's plain version == JAX polar_inverse_stft_pallas (interpret mode),
    also on the strided freq-major views the decoder hands it."""
    from quickvc_tpu.ops.fused_istft import polar_inverse_stft_pallas
    from quickvc_tpu_torch.ops import fused_istft

    b, f = shape
    log_mag = rng.standard_normal((b, f, 9)).astype(np.float32) * 0.5
    phase = rng.standard_normal((b, f, 9)).astype(np.float32)
    golden = np.asarray(_pallas_interpret(
        polar_inverse_stft_pallas, jnp.asarray(log_mag), jnp.asarray(phase), 16, 4))
    before = fused_istft.STATS.launches
    ours = fused_istft.polar_inverse_stft(t(log_mag), t(phase), 16, 4).numpy()
    assert ours.shape == golden.shape == (b, 4 * (f - 1))
    np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)
    spec = t(np.concatenate([log_mag, phase], axis=2).transpose(0, 2, 1)).transpose(1, 2)
    strided = fused_istft.polar_inverse_stft(spec[..., :9], spec[..., 9:], 16, 4).numpy()
    np.testing.assert_array_equal(strided, ours)
    assert fused_istft.STATS.launches == before


def test_polar_istft_plain_matches_torch_istft(rng):
    """The plain head is torch.istft(center=True, Hann) of the polar spectrum."""
    from quickvc_tpu_torch.dsp.istft import polar_inverse_stft

    log_mag = t(rng.standard_normal((2, 50, 9)).astype(np.float32) * 0.5)
    phase = t(rng.standard_normal((2, 50, 9)).astype(np.float32))
    z = torch.polar(torch.exp(log_mag), torch.pi * torch.sin(phase)).transpose(1, 2)
    golden = torch.istft(z, 16, 4, 16, torch.hann_window(16), center=True)
    np.testing.assert_allclose(polar_inverse_stft(log_mag, phase, 16, 4).numpy(),
                               golden.numpy(), atol=1e-5, rtol=1e-4)


def test_groupnorm_closed_form_matches_jax(rng):
    from quickvc_tpu.ops.fused_extractor import groupnorm_affine_closed_form as jax_gn
    from quickvc_tpu_torch.ops.fused_extractor import groupnorm_affine_closed_form

    wav = rng.standard_normal((2, 4003)).astype(np.float32) * 0.3
    w = rng.standard_normal((32, 1, 10)).astype(np.float32) * 0.3   # torch layout
    gamma = rng.standard_normal(32).astype(np.float32)
    beta = rng.standard_normal(32).astype(np.float32)
    ours = groupnorm_affine_closed_form(t(wav), t(w), t(gamma), t(beta))
    theirs = jax_gn(jnp.asarray(wav), jnp.asarray(w.transpose(2, 1, 0)),
                    jnp.asarray(gamma), jnp.asarray(beta))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
