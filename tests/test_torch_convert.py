"""PyTorch port, the slice end to end: units -> d-vector -> infer -> wave
against the JAX package at a tiny config, and the conversion CLI on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_support import TINY_MODEL, t, tiny_generator, tiny_hubert

REPO = Path(__file__).resolve().parents[1]


def test_slice_matches_jax(rng):
    """Source units, target log-mel d-vector, infer at noise 0: the port's
    plain path equals the JAX package's within 1e-3 x max|wave|."""
    from quickvc_tpu.dsp.mel import mel_filterbank
    from quickvc_tpu.dsp.stft import wave_to_mel as jax_wave_to_mel
    from quickvc_tpu.models.encoders import embed_utterance_batch
    from quickvc_tpu.models.hubert import HubertSoft as JaxHubert
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
    from quickvc_tpu_torch.models.encoders import embed_utterance
    from quickvc_tpu_torch.ops.fused_mel import wave_to_mel

    net, g_params, port = tiny_generator(seed=5)
    jhub, h_params, hub = tiny_hubert("faststats", seed=6)
    src = rng.standard_normal((2, 9600)).astype(np.float32) * 0.3
    tgt = rng.standard_normal((1, 48000)).astype(np.float32) * 0.3  # 150 frames: 2 windows

    fb = jnp.asarray(mel_filterbank(16000, 1280, 80))
    j_units = jax.jit(lambda p, w: jhub.apply({"params": p}, w, method=JaxHubert.units))(
        h_params, jnp.asarray(src))
    j_mel = jax_wave_to_mel(jnp.asarray(tgt), fb, 1280, 320, 1280)
    j_g = embed_utterance_batch(
        lambda p, m: net.apply({"params": p}, m, method=JaxSynth.embed_speaker),
        g_params, j_mel)
    infer = jax.jit(lambda p, u, g: net.apply({"params": p}, u, g, 0.0, method=JaxSynth.infer))
    golden = np.asarray(infer(g_params, j_units, jnp.concatenate([j_g, j_g])))[..., 0]

    with torch.no_grad():
        units = hub.units(t(src))
        g = embed_utterance(port.enc_spk, wave_to_mel(t(tgt), 16000, 1280, 320, 1280, 80))
        wave = port.infer(units.transpose(1, 2), torch.cat([g, g]), noise_scale=0.0)[:, 0]
    np.testing.assert_allclose(units.numpy(), np.asarray(j_units), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), atol=1e-4, rtol=1e-3)
    assert wave.shape == golden.shape == (2, 9600)
    assert np.abs(wave.numpy() - golden).max() <= 1e-3 * np.abs(golden).max()


def _write_checkpoints(tmp_path: Path) -> tuple[str, str, str]:
    """Full-size seeded HuBERT (as a DataParallel bshall .pt with its
    training-only entries) and a tiny-config reference-layout G .pth."""
    from quickvc_tpu_torch.config import ModelConfig, QuickVCConfig
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import init_random_

    sd = init_random_(HubertSoft(), seed=1).state_dict()
    sd = {f"module.{k}": v for k, v in sd.items()}
    sd["module.masked_spec_embed"] = torch.zeros(768)
    sd["module.label_embedding.weight"] = torch.zeros(100, 256)
    hubert = str(tmp_path / "hubert-soft.pt")
    torch.save({"hubert": sd, "step": 0}, hubert)

    mc = dict(TINY_MODEL, unit_channels=256)
    cfg = QuickVCConfig(model=ModelConfig(**mc))
    net = init_random_(SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model), seed=2)
    ptfile = str(tmp_path / "G_0.pth")
    torch.save({"model": net.state_dict(), "iteration": 0, "optimizer": None,
                "learning_rate": 2e-4}, ptfile)
    hpfile = str(tmp_path / "config.json")
    cfg.save(hpfile)
    return hpfile, ptfile, hubert


def test_cli_converts_on_cpu(tmp_path, rng):
    from quickvc_tpu_torch.data.audio_io import read_wav, write_wav

    hpfile, ptfile, hubert = _write_checkpoints(tmp_path)
    src, tgt = tmp_path / "src.wav", tmp_path / "tgt.wav"
    write_wav(str(src), (rng.standard_normal(16000 + 100) * 0.2).astype(np.float32), 16000)
    write_wav(str(tgt), (rng.standard_normal(22050) * 0.2).astype(np.float32), 22050)
    txt = tmp_path / "convert.txt"
    txt.write_text(f"pair0|{src}|{tgt}\n")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "quickvc_tpu_torch.convert", "--device", "cpu",
         "--hpfile", hpfile, "--ptfile", ptfile, "--hubert", hubert,
         "--txtpath", str(txt), "--outdir", str(out), "--batch", "2",
         "--host-workers", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    wav, sr = read_wav(str(out / "pair0.wav"))
    assert sr == 16000 and wav.dtype == np.float32
    assert len(wav) == (16100 // 320) * 320
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_cli_streaming_interior_matches_batch_cli(tmp_path, rng):
    """``--streaming`` (default 96-frame chunks and context) writes the batch
    CLI's audio away from the utterance edges, and the same length."""
    from quickvc_tpu_torch import convert
    from quickvc_tpu_torch.data.audio_io import read_wav, write_wav

    hpfile, ptfile, hubert = _write_checkpoints(tmp_path)
    src, tgt = tmp_path / "src.wav", tmp_path / "tgt.wav"
    write_wav(str(src), (rng.standard_normal(30400 + 50) * 0.2).astype(np.float32), 16000)
    write_wav(str(tgt), (rng.standard_normal(16000) * 0.2).astype(np.float32), 16000)
    txt = tmp_path / "convert.txt"
    txt.write_text(f"pair0|{src}|{tgt}\n")
    waves = {}
    for name, extra in (("batch", []), ("streaming", ["--streaming"])):
        convert.main(["--device", "cpu", "--hpfile", hpfile, "--ptfile", ptfile,
                      "--hubert", hubert, "--txtpath", str(txt), "--outdir",
                      str(tmp_path / name), "--noise-scale", "0", "--host-workers", "1",
                      *extra])
        waves[name], _ = read_wav(str(tmp_path / name / "pair0.wav"))
    assert len(waves["streaming"]) == len(waves["batch"]) == 95 * 320   # two 96-frame windows
    edge = 32 * 320   # beyond the tiny model's ~20-frame receptive field
    a, b = (w[edge:-edge] for w in (waves["batch"], waves["streaming"]))
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
