"""Host audio I/O: WAV and FLAC reads, WAV writes, resampling, silence
trimming, peak normalisation (numpy/scipy and the native decoder).

The port's own copy of ``quickvc_tpu/data/audio_io.py``: ``read_wav`` gives
float32 in [-1, 1] through scipy; ``read_audio`` reads FLAC through the
native decoder (:mod:`quickvc_tpu_torch.data.native`), and WAV through it
too, with scipy for a WAV subformat the decoder refuses; ``resample`` is
polyphase, ``trim_silence`` follows ``librosa.effects.trim`` (frame RMS
against ``top_db`` below the peak, frame 2048 / hop 512), ``write_wav``
writes float32 like reference ``convert.py:84-86`` and ``write_wav_int16``
the preprocessing step's 16-bit PCM.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64
        x = data.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, int(sr)


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read WAV or FLAC -> (float32 mono samples in [-1, 1], sample_rate).

    FLAC needs the native decoder: if it cannot be built, that is an error.
    A WAV whose subformat the decoder refuses is read by :func:`read_wav`.
    """
    from quickvc_tpu_torch.data import native

    if path.lower().endswith(".flac"):
        return native.read_audio(path)
    try:
        return native.read_audio(path)
    except IOError:
        return read_wav(path)


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 samples."""
    wavfile.write(path, sr, x.astype(np.float32))


def write_wav_int16(path: str, x: np.ndarray, sr: int) -> None:
    """Write 16-bit PCM (the preprocessing step's output format)."""
    x = np.clip(x, -1.0, 1.0)
    wavfile.write(path, sr, (x * 32767.0).astype(np.int16))


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample to target_sr."""
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly  # 3 s to import: only where resampling runs

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def _frame_rms(x: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Centered frame RMS (librosa.feature.rms semantics: constant pad)."""
    pad = frame_length // 2
    xp = np.pad(x, (pad, pad))
    n_frames = 1 + (len(xp) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(xp[idx] ** 2, axis=1))


def trim_silence(
    x: np.ndarray, top_db: float = 20.0,
    frame_length: int = 2048, hop_length: int = 512,
) -> tuple[np.ndarray, tuple[int, int]]:
    """Trim leading/trailing audio more than top_db below peak RMS."""
    rms = _frame_rms(x, frame_length, hop_length)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    non_silent = db > (db.max() - top_db)
    if not non_silent.any():
        return x, (0, len(x))
    frames = np.flatnonzero(non_silent)
    start = int(frames[0]) * hop_length
    end = min(len(x), int(frames[-1] + 1) * hop_length)
    return x[start:end], (start, end)


def peak_normalize(x: np.ndarray, peak: float = 0.95) -> np.ndarray:
    """Scale so max |x| == peak (the preprocessing step)."""
    m = np.abs(x).max()
    return x if m == 0 else (x / m * peak).astype(np.float32)
