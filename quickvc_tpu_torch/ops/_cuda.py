"""Build and load the port's CUDA kernels: ``nvcc`` -> one shared library -> ctypes.

The sources under ``quickvc_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so each compiles in seconds. At first use
:func:`library` compiles every source at once (one ``nvcc`` process each,
for ``sm_90a``), links them into ``libqvc_<hash>.so`` and loads it: in a
checkout of the repo under ``build/quickvc_tpu_torch/``, for an installed
package under the user's cache directory (``$XDG_CACHE_HOME`` or
``~/.cache``, then ``quickvc_tpu_torch/``). The name carries a hash of the
sources and the headers they share, so an edited file is rebuilt, and a file
lock serialises builds from concurrent processes. Nothing is built when the
package is imported.

Every C entry point takes device pointers and a stream as ``void*``, launches
on that stream and returns ``cudaGetLastError()``; :func:`check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_mel.cu", "fused_istft.cu", "fused_attention.cu", "fused_disc_conv.cu",
           "conv5_wgmma.cu", "fused_extractor.cu", "extractor_wgmma.cu", "fused_transformer.cu",
           "int8_mm.cu", "mma_rate.cu", "lstm_recurrence.cu")
HEADERS = ("bf16_gemm.cuh", "fused_attention.cuh", "fused_attention_bf16.cuh",
           "splitk_bf16.cuh", "tf32x3.cuh", "tma_wgmma.cuh", "wgmma_bf16.cuh")  # included by the sources
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "qvc_wave_to_mel": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "qvc_wave_to_mel_fft": [_P] * 5 + [_I] * 7 + [_P],
    "qvc_wave_to_spec_halo": [_P, _P, _P] + [_I] * 6 + [_P],
    "qvc_wave_to_spec_halo_dense": [_P, _P] + [_I] * 6 + [_P],
    "qvc_polar_istft": [_P, _P] + [_L] * 6 + [_P, _I, _I, _I, _I, _P, _P, _I, _P],
    "qvc_attention_packed": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F, _P],
    "qvc_attention_packed_bf16": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_F] + [_I] * 3 + [_P],
    "qvc_attention_headed": [_P] * 4 + [_I] * 4 + [_L] * 9 + [_F, _P],
    "qvc_attention_headed_bf16": [_P] * 4 + [_I] * 4 + [_L] * 9 + [_F] + [_I] * 3 + [_P],
    "qvc_attention_bf16_occupancy": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
    "qvc_conv5_lrelu": [_P, _P, _P, _P] + [_I] * 4 + [_F, _P],
    "qvc_conv5_dw": [_P] * 4 + [_I] * 6 + [_P],
    "qvc_conv5_lrelu_bf16": [_P, _P, _P, _P] + [_I] * 4 + [_F, _P],
    "qvc_conv5_dw_bf16": [_P] * 4 + [_I] * 6 + [_P],
    "qvc_conv5_lrelu_bf16_wgmma": [_P, _P, _P, _P] + [_I] * 4 + [_F, _I, _P],
    "qvc_conv5_dw_bf16_wgmma": [_P] * 4 + [_I] * 7 + [_P],
    "qvc_conv5_wgmma_attributes": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "qvc_extractor_front": [_P] * 6 + [_I] * 4 + [_P],
    "qvc_extractor_front_bf16": [_P] * 6 + [_I] * 4 + [_P],
    "qvc_extractor_front_bf16_wgmma": [_P] * 6 + [_I] * 5 + [_P],
    "qvc_transformer_layer": [_P] * 20 + [_I] * 5 + [_F] + [_I] * 8 + [_P],
    "qvc_transformer_layer_bf16": [_P] * 20 + [_I] * 5 + [_F] + [_I] * 15 + [_P],
    "qvc_transformer_layer_launches": [_I] * 4,
    "qvc_mm_s8": [_P] * 3 + [_I] * 4 + [_P],
    "qvc_mm_bf16": [_P] * 3 + [_I] * 4 + [_P],
    "qvc_mm_probe": [_I, _I] + [_P] * 3 + [_I] * 4 + [_P],
    "qvc_mm_transpose": [_P, _P] + [_I] * 2 + [_P],
    "qvc_mma_tf32_rate": [_P, _I, _I, _P],
    "qvc_lstm_stack_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "qvc_lstm_stack_max_clusters": [_I] * 6,
    "qvc_lstm_stack_backward_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "qvc_lstm_stack_backward_max_clusters": [_I] * 5,
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


class KernelStats:
    """Launch count of one kernel, in all and by route (for a kernel with
    several); a wrapper adds one per kernel launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.routes: Counter[str] = Counter()

    def count(self, route: str | None = None) -> None:
        self.launches += 1
        if route is not None:
            self.routes[route] += 1

    def reset(self) -> None:
        self.launches = 0
        self.routes.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME)")


def build_dir() -> Path:
    """Where the library is built: the checkout's ``build/`` when the package
    runs from a checkout of the repo, else a per-user cache directory."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists() and (root / "quickvc_tpu_torch").is_dir():
        return root / "build" / "quickvc_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "quickvc_tpu_torch"


def _sources_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if not yet built) and return the library path."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libqvc_{_sources_hash()}.so"
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        nvcc = _nvcc()
        procs = []
        for name in SOURCES:
            obj = out_dir / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            print("\n".join(log), file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {failed}; see {out_dir}/build.log")
        tmp = lib_path.with_suffix(".tmp")
        subprocess.run([nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp),
                        *[str(obj) for _, obj, _ in procs]], check=True)
        tmp.rename(lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the host plans fill
    their waves of blocks from it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_tensor_device(launch):
    """Run a kernel's launcher with its first argument's card as the current
    device. The C side launches on the current device and sizes its grids
    from it (``cudaGetDevice``), so a ``cuda:1`` tensor in a process whose
    current device is card 0 would otherwise hand card 1's pointers to a
    launch on card 0."""

    @functools.wraps(launch)
    def wrapper(*args, **kwargs):
        t = args[0]
        if isinstance(t, torch.Tensor) and t.is_cuda:
            with torch.cuda.device(t.device):
                return launch(*args, **kwargs)
        return launch(*args, **kwargs)

    return wrapper


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    """Raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through a kernel that has none.

    A ctypes kernel's output carries no ``grad_fn``: differentiating through
    it would silently give every earlier layer no gradient. The dispatchers
    call this on both devices, so the CPU tests see the card's contract.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            "tensors that do not require grad (training differentiates "
            "through the plain version instead)")


F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)
# why a float32-only kernel refuses bf16: K1, K3 and K4 have no bf16 mode in
# JAX either (its bf16 paths cast at their edges)
AT_EDGE = "the JAX kernel computes in float32 too; a bf16 path casts at its edge"


def require_dtype(name: str, *tensors: torch.Tensor, dtypes=F32, why: str = "") -> torch.dtype:
    """Raise TypeError unless every tensor has one dtype, and one of ``dtypes``
    (``why`` says why another is refused); returns that dtype. The
    dispatchers call it on both devices, so the CPU tests see the card's
    contract."""
    for t in tensors:
        if t.dtype not in dtypes:
            takes = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{name}: kernel takes {takes}, got {t.dtype}"
                            + (f" ({why})" if why else ""))
    kinds = {t.dtype for t in tensors}
    if len(kinds) > 1:
        raise TypeError(f"{name}: inputs of one dtype, got {[str(t.dtype) for t in tensors]}")
    return kinds.pop()


def require_device(name: str, *tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor is on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")


def require_cuda(name: str, *tensors: torch.Tensor, dtypes=F32, why: str = "") -> torch.dtype:
    """Raise unless every tensor is on one CUDA device (ValueError) with one
    dtype of ``dtypes`` (TypeError); returns that dtype."""
    require_device(name, *tensors)
    return require_dtype(name, *tensors, dtypes=dtypes, why=why)
