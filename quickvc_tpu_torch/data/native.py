"""ctypes binding of the native audio decoder (``native/qvc_audio.cpp``): FLAC and WAV.

The port's own copy of ``quickvc_tpu/data/native.py``: ``qvc_probe`` reads
a file's header (sample rate, channels, bits, exact frame count) and
``qvc_decode`` its samples as interleaved int32. At first use
:func:`library` compiles the C++ source with ``g++ -O2 -fPIC -std=c++17
-shared`` (``native/Makefile``'s flags) into the build directory of the
port's CUDA kernels (``build/quickvc_tpu_torch/`` in a checkout), under a
file lock, so concurrent loader workers build it once. A failed build or
load raises with the compiler's output; nothing is written into
``native/``, and importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "qvc_audio.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
KIND_FLAC, KIND_WAV = 1, 2

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build native/qvc_audio.cpp")
    return cxx


def build() -> Path:
    """Compile the decoder (if not yet built) and return the library's path."""
    from quickvc_tpu_torch.ops._cuda import build_dir

    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing: the audio decoder is built from a checkout")
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    lib_path = out_dir / f"libqvc_audio_{digest[:16]}.so"
    with open(out_dir / "audio_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0 or not tmp.exists():
            raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.rename(lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded decoder, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.qvc_probe.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4 + [
                ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
            lib.qvc_probe.restype = ctypes.c_int
            lib.qvc_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                       ctypes.c_longlong]
            lib.qvc_decode.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def _probe(path: str) -> dict:
    ints = [ctypes.c_int() for _ in range(4)]
    frames, floatfmt = ctypes.c_longlong(), ctypes.c_int()
    rc = library().qvc_probe(os.fsencode(path), *map(ctypes.byref, ints), ctypes.byref(frames),
                             ctypes.byref(floatfmt))
    if rc != 0:
        raise IOError(f"qvc_probe failed ({rc}) for {path}")
    kind, sr, ch, bps = (v.value for v in ints)
    return {"kind": kind, "sample_rate": sr, "channels": ch, "bps": bps,
            "frames": frames.value, "float": bool(floatfmt.value)}


def probe(path: str) -> tuple[int, int]:
    """(frames per channel, sample rate) from the container's header: the
    exact length of a compressed file, whose size is no sample count."""
    info = _probe(path)
    return info["frames"], info["sample_rate"]


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Decode FLAC or WAV -> (float32 mono samples in [-1, 1], sample rate);
    channels are averaged."""
    info = _probe(path)
    ch = info["channels"]
    buf = np.empty(info["frames"] * ch, dtype=np.int32)
    got = library().qvc_decode(os.fsencode(path),
                               buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), buf.size)
    if got < 0:
        raise IOError(f"qvc_decode failed ({got}) for {path}")
    x = buf[: got * ch].reshape(-1, ch).astype(np.float32)
    if info["float"]:
        x /= 8388608.0   # the decoder's float WAV path gives Q8.23
    else:
        x /= float(1 << (info["bps"] - 1))
    return x.mean(axis=1), info["sample_rate"]
