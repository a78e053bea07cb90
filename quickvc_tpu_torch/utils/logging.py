"""Logging and observability: the file logger, spectrogram images, and
TensorBoard event files written with the standard library and numpy.

The port's own copy of ``quickvc_tpu/utils/logging.py`` (reference
``utils.py:206-257``), with no tensorboard, tensorboardX, protobuf,
matplotlib or soundfile: :class:`Summarizer` encodes the ``Event`` and
``Summary`` protobuf messages by hand (field numbers of
``tensorboard/compat/proto/event_pb2.py`` and ``summary_pb2.py``) and frames
them as TFRecords, images are PNGs from ``zlib``, audio is 16-bit WAV from
the ``wave`` module. TensorBoard reads the files as its own::

    tensorboard --logdir MODEL_DIR    # MODEL_DIR/eval holds the eval run
"""

from __future__ import annotations

import io
import logging
import os
import socket
import struct
import sys
import time
import wave
import zlib
from typing import Mapping

import numpy as np


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    """A logger writing to ``model_dir/filename`` and INFO to stdout; keyed by
    the full log path, so two runs in one process keep their own files."""
    target = os.path.abspath(os.path.join(model_dir, filename))
    logger = logging.getLogger(f"quickvc_tpu_torch[{target}]")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if not any(isinstance(h, logging.FileHandler) and h.baseFilename == target
               for h in logger.handlers):
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        os.makedirs(model_dir, exist_ok=True)
        fh = logging.FileHandler(target)
        fh.setFormatter(logging.Formatter("%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(logging.INFO)
        logger.addHandler(sh)
    return logger


# viridis at nine evenly spaced points; plot_spectrogram interpolates 256 colours
_ANCHORS = np.array([[68, 1, 84], [71, 45, 123], [59, 82, 139], [44, 114, 142],
                     [33, 145, 140], [39, 173, 129], [92, 200, 99], [170, 220, 50],
                     [253, 231, 37]], np.float64)
_COLOURS = np.stack([np.interp(np.linspace(0, 1, 256), np.linspace(0, 1, len(_ANCHORS)),
                               _ANCHORS[:, c]) for c in range(3)], axis=1).round().astype(np.uint8)


def plot_spectrogram(spectrogram: np.ndarray) -> np.ndarray:
    """Render a (freq, frames) spectrogram to an HWC uint8 image: the lowest
    channel at the bottom, each value through a fixed 256-colour table
    scaled from the array's minimum to its maximum, each cell 2x2 pixels."""
    x = np.asarray(spectrogram, np.float64)
    lo, hi = float(x.min()), float(x.max())
    idx = np.round((x - lo) / (hi - lo) * 255).astype(np.int64) if hi > lo else np.zeros(
        x.shape, np.int64)
    img = _COLOURS[idx[::-1]]
    return np.ascontiguousarray(img.repeat(2, axis=0).repeat(2, axis=1))


# ---------------------------------------------------------------------------
# encoders: PNG, WAV, protobuf fields, TFRecord framing


def encode_png(img: np.ndarray) -> bytes:
    """HWC uint8 (C = 3 or 1) -> PNG bytes (8-bit RGB or grey, no filter)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"image of {c} channels: PNG here takes 1 or 3")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def encode_wav(x: np.ndarray, sr: int) -> bytes:
    """Mono float audio in [-1, 1] -> 16-bit PCM WAV bytes."""
    pcm = (np.clip(np.asarray(x, np.float64).reshape(-1), -1.0, 1.0) * 32767).round()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 negatives as protobuf writes them
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_varint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(int(n))


def _f_double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(x))


def _f_float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(x))


def _f_bytes(field: int, data: bytes | str) -> bytes:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _key(field, 2) + _varint(len(data)) + data


def _f_packed_doubles(field: int, xs) -> bytes:
    return _f_bytes(field, np.asarray(xs, "<f8").tobytes())


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord framing uses it."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: u64 length, masked CRC-32C of the length, the bytes,
    masked CRC-32C of the bytes (all little-endian)."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _event(step: int, **fields: bytes) -> bytes:
    """An ``Event``: wall_time (1), step (2), then file_version (3) or
    summary (5) already encoded."""
    out = _f_double(1, time.time()) + _f_varint(2, step)
    if "file_version" in fields:
        out += _f_bytes(3, fields["file_version"])
    if "summary" in fields:
        out += _f_bytes(5, fields["summary"])
    return out


def _value(tag: str, payload: bytes) -> bytes:
    """``Summary.value`` (1) holding a ``Value``: tag (1) and its payload."""
    return _f_bytes(1, _f_bytes(1, tag) + payload)


def scalar_value(tag: str, x: float) -> bytes:
    return _value(tag, _f_float(2, x))                       # simple_value


def image_value(tag: str, img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    body = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c)
            + _f_bytes(4, encode_png(img)))
    return _value(tag, _f_bytes(4, body))                    # image


def audio_value(tag: str, x: np.ndarray, sr: int) -> bytes:
    n = int(np.asarray(x).size)
    body = (_f_float(1, sr) + _f_varint(2, 1) + _f_varint(3, n)
            + _f_bytes(4, encode_wav(x, sr)) + _f_bytes(5, "audio/wav"))
    return _value(tag, _f_bytes(6, body))                    # audio


def histogram_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    v = np.asarray(values, np.float64).reshape(-1)
    if v.size == 0:
        raise ValueError(f"histogram {tag!r} of no values")
    counts, edges = np.histogram(v, bins=bins)
    body = (_f_double(1, v.min()) + _f_double(2, v.max()) + _f_double(3, v.size)
            + _f_double(4, v.sum()) + _f_double(5, (v * v).sum())
            + _f_packed_doubles(6, edges[1:]) + _f_packed_doubles(7, counts))
    return _value(tag, _f_bytes(5, body))                    # histo


class Summarizer:
    """TensorBoard writer (scalars, histograms, images, audio) into one
    ``events.out.tfevents.<time>.<host>...`` file under ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.logdir = log_dir
        stem = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
        n = 0
        while True:  # a unique name: two writers in one second never share a file
            path = os.path.join(log_dir, f"{stem}.{os.getpid()}.{n}")
            try:
                self._file = open(path, "xb")
                break
            except FileExistsError:
                n += 1
        self.path = path
        self._file.write(tfrecord(_event(0, file_version="brain.Event:2")))
        self._file.flush()

    def _write(self, step: int, values: list[bytes]) -> None:
        if values:
            self._file.write(tfrecord(_event(step, summary=b"".join(values))))

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        """One scalar a key; a vector value ``v`` of key ``k`` as ``k/i``."""
        out = []
        for k, v in values.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                out.append(scalar_value(k, float(arr)))
            else:  # per-discriminator vectors etc.
                out.extend(scalar_value(f"{k}/{i}", float(x)) for i, x in enumerate(arr.ravel()))
        self._write(step, out)

    def histograms(self, step: int, values: Mapping[str, np.ndarray]) -> None:
        self._write(step, [histogram_value(k, v) for k, v in values.items()])

    def images(self, step: int, values: Mapping[str, np.ndarray]) -> None:
        """HWC uint8 images."""
        self._write(step, [image_value(k, v) for k, v in values.items()])

    def audios(self, step: int, values: Mapping[str, np.ndarray], sr: int) -> None:
        """Mono float waves in [-1, 1]."""
        self._write(step, [audio_value(k, v, sr) for k, v in values.items()])

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
