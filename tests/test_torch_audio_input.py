"""PyTorch port, audio input: the native decoder's binding, ``read_audio``,
FLAC corpora in the dataset and the preprocessing CLI, against the JAX package.

FLAC files come from ``tests/test_native_audio.py:encode_flac`` (verbatim
subframes; 24-bit ones with their frame headers' sample-size code set to
24, see :func:`flac_bytes`). Reads and probes are held bit for bit; the
dataset's bucket lengths and items on a FLAC corpus against the JAX
dataset's; ``python -m quickvc_tpu_torch.downsample`` against the root
``downsample.py:process_one`` byte for byte, on a FLAC and a WAV tree; and a
decoder that cannot be built raises with the compiler's output.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

import torch_port_support  # noqa: F401  (caps torch's CPU threads)
from test_native_audio import crc8, crc16, encode_flac

HOP = 320


def flac_bytes(data: np.ndarray, sr: int = 16000, bps: int = 16, blocksize: int = 256) -> bytes:
    """``encode_flac`` of (N, C) int samples at ``bps`` 16 or 24. Its frame
    headers name 16-bit samples; at 24 each header's sample-size code is set
    to 24 bits (code 6) and both CRCs recomputed."""
    raw = bytearray(encode_flac(data, sr=sr, bps=bps, blocksize=blocksize))
    if bps == 16:
        return bytes(raw)
    n, c = data.shape
    pos, start = 4 + 4 + 34, 0          # "fLaC", the STREAMINFO block's header and body
    while start < n:
        bs = min(blocksize, n - start)
        size = 8 + (c * (8 + bs * bps) + 7) // 8 + 2   # header, verbatim subframes, CRC-16
        frame = raw[pos : pos + size]
        frame[3] = ((c - 1) << 4) | (6 << 1)
        frame[7] = crc8(bytes(frame[:7]))
        frame[-2:] = crc16(bytes(frame[:-2])).to_bytes(2, "big")
        raw[pos : pos + size] = frame
        pos, start = pos + size, start + bs
    assert pos == len(raw)
    return bytes(raw)


def samples(rng, n: int, channels: int, bps: int) -> np.ndarray:
    peak = (1 << (bps - 1)) - 1
    t = np.arange(n)[:, None]
    wave = 0.4 * np.sin(t * 0.01 * (1 + np.arange(channels))) + 0.05 * rng.standard_normal(
        (n, channels))
    return np.round(np.clip(wave, -1, 1) * peak).astype(np.int64)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bps", [16, 24])
def test_flac_read_and_probe_match_jax(tmp_path, rng, bps, channels):
    from quickvc_tpu.data import native as jax_native
    from quickvc_tpu.data.audio_io import read_audio as jax_read_audio
    from quickvc_tpu_torch.data import native
    from quickvc_tpu_torch.data.audio_io import read_audio

    data = samples(rng, 1500, channels, bps)
    path = str(tmp_path / f"x{bps}_{channels}.flac")
    with open(path, "wb") as f:
        f.write(flac_bytes(data, sr=48000, bps=bps))
    x, sr = read_audio(path)
    golden, gsr = jax_read_audio(path)
    assert sr == gsr == 48000 and x.dtype == np.float32
    np.testing.assert_array_equal(x, golden)
    np.testing.assert_array_equal(x, data.astype(np.float32).mean(axis=1) / (1 << (bps - 1)))
    assert native.probe(path) == jax_native.probe(path) == (1500, 48000)


def test_wav_reads_match_jax(tmp_path, rng):
    """s16 and float32 WAVs through the decoder, and a WAV subformat it
    refuses (64-bit float) through scipy, as the JAX reader does."""
    from quickvc_tpu.data.audio_io import read_audio as jax_read_audio
    from quickvc_tpu_torch.data.audio_io import read_audio, read_wav

    paths = {"s16": (rng.standard_normal(4000) * 8000).astype(np.int16),
             "f32": (0.3 * rng.standard_normal(3000)).astype(np.float32),
             "s16_stereo": (rng.standard_normal((2000, 2)) * 8000).astype(np.int16)}
    for name, data in paths.items():
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, 16000, data)
        x, sr = read_audio(path)
        golden, _ = jax_read_audio(path)
        np.testing.assert_array_equal(x, golden)
        np.testing.assert_allclose(x, read_wav(path)[0], atol=1e-6)   # float WAVs pass Q8.23
    # a 64-bit float WAV: scipy reads it, the native decoder refuses it
    path = str(tmp_path / "f64.wav")
    wavfile.write(path, 16000, (0.3 * rng.standard_normal(1000)).astype(np.float64))
    np.testing.assert_array_equal(read_audio(path)[0], jax_read_audio(path)[0])


def write_flac_corpus(root, rng, seconds, unit_channels: int = 12) -> str:
    """16 kHz FLACs (mono, 24-bit: 1.5 times the bytes of s16) under root/spk{i % 2}/ with unit .npy
    siblings; returns a train.txt listing them."""
    paths = []
    for i, sec in enumerate(seconds):
        spk = root / f"spk{i % 2}"
        spk.mkdir(parents=True, exist_ok=True)
        n = int(sec * 16000)
        path = spk / f"utt{i}.flac"
        path.write_bytes(flac_bytes(samples(rng, n, 1, 24), bps=24, blocksize=4096))
        np.save(spk / f"utt{i}.npy",
                rng.standard_normal((n // HOP, unit_channels)).astype(np.float32))
        paths.append(str(path))
    listing = root / "train.txt"
    listing.write_text("".join(f"{p}|spk\n" for p in paths))
    return str(listing)


def test_flac_corpus_matches_jax_dataset(tmp_path):
    """Bucket lengths from the exact probe (not the file size), file lists of
    a FLAC directory, and items, against the JAX dataset."""
    from test_torch_train_data import _both_configs

    from quickvc_tpu.data.dataset import UnitAudioSpecDataset as JaxDataset
    from quickvc_tpu.data.dataset import load_filepaths as jax_lists
    from quickvc_tpu_torch.data.dataset import UnitAudioSpecDataset, load_filepaths

    seconds = [0.8, 1.05, 0.75, 1.3, 0.95]
    listing = write_flac_corpus(tmp_path, np.random.default_rng(2), seconds)
    for mode in ("train", "eval"):
        assert load_filepaths(str(tmp_path), mode) == jax_lists(str(tmp_path), mode)
    cfg, jcfg = _both_configs(listing, "full")
    ours = UnitAudioSpecDataset("train", cfg, cache_specs=False)
    golden = JaxDataset("train", jcfg, cache_specs=False)
    assert ours.audiopaths == golden.audiopaths
    assert ours.lengths == golden.lengths
    by_path = dict(zip(ours.audiopaths, ours.lengths))
    for i, sec in enumerate(seconds):
        path = str(tmp_path / f"spk{i % 2}" / f"utt{i}.flac")
        assert by_path[path] == int(sec * 16000) // HOP
        assert os.path.getsize(path) // (2 * HOP) != by_path[path]   # the size is no count
    for i in range(len(ours)):
        a, b = ours[i], golden[i]
        np.testing.assert_array_equal(a["wave"], b["wave"])
        np.testing.assert_array_equal(a["unit"], b["unit"])
        np.testing.assert_allclose(a["spec"], b["spec"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("extension", [".flac", ".wav"])
@pytest.mark.parametrize("out_dir", [True, False])
def test_downsample_cli_matches_root_script(tmp_path, rng, extension, out_dir):
    """48 kHz mono and stereo inputs (FLAC, or s16 WAV of the same samples)
    -> 16 kHz s16 files byte-equal to the root script's ``process_one``."""
    import downsample as root_script

    from quickvc_tpu_torch import downsample

    tree = tmp_path / "in"
    for i, (seconds, channels) in enumerate([(0.6, 1), (0.9, 2), (0.45, 1)]):
        d = tree / f"spk{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        data = samples(rng, int(48000 * seconds), channels, 16)
        data[: 4800] //= 40   # a quiet lead-in for the 20-dB trim to cut
        if extension == ".flac":
            (d / f"utt{i}.flac").write_bytes(flac_bytes(data, sr=48000, blocksize=4096))
        else:
            wavfile.write(str(d / f"utt{i}.wav"), 48000, data.astype(np.int16))
    args = ["--in-dir", str(tree), "--extension", extension, "--num-workers", "2"]
    if out_dir:
        args += ["--out-dir", str(tmp_path / "out")]
    jobs = downsample.main(args)
    assert len(jobs) == 3
    for src, dst in jobs:
        assert dst.endswith(".wav" if out_dir else ".16k.wav")
        golden = str(tmp_path / "golden" / os.path.basename(dst))
        assert root_script.process_one((src, golden)) is None
        with open(dst, "rb") as a, open(golden, "rb") as b:
            assert a.read() == b.read(), dst
        sr, wav = wavfile.read(dst)
        assert sr == 16000 and wav.dtype == np.int16 and wav.ndim == 1


def test_unbuildable_decoder_raises(tmp_path, monkeypatch, rng):
    """A compiler that fails stops the build with its output; a FLAC read, a
    FLAC corpus and the preprocessing CLI then raise, never skip or return
    silence."""
    from quickvc_tpu_torch import downsample
    from quickvc_tpu_torch.data import audio_io, native
    from quickvc_tpu_torch.ops import _cuda

    path = tmp_path / "a.flac"
    path.write_bytes(flac_bytes(samples(rng, 800, 1, 16)))
    broken = tmp_path / "cxx"
    broken.write_text("#!/bin/sh\necho 'qvc_audio.cpp: error: no compiler here' >&2\nexit 1\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CXX", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_cuda, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.build()
    with pytest.raises(RuntimeError, match="no compiler here"):
        audio_io.read_audio(str(path))
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.probe(str(path))
    with pytest.raises(RuntimeError, match="no compiler here"):
        downsample.main(["--in-dir", str(tmp_path), "--extension", ".flac",
                         "--num-workers", "1"])
    assert not (tmp_path / "a.16k.wav").exists() and native._lib is None
    assert not list((tmp_path / "build").glob("*.so"))
