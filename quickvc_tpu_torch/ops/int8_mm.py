"""Kernel K11: a tensor-core GEMM, s8 x s8 -> s32 and bf16 x bf16 -> f32 (``csrc/int8_mm.cu``).

Replaces the TPU kernel ``scripts/int8_matmul_probe.py:pallas_mm``, which
probes whether a hand-written kernel reaches the chip's int8 rate. A and B
are row-major (M, K) and (K, N). :func:`mm` takes the plain version,
:func:`mm_reference`, for CPU tensors and launches the kernel for CUDA
tensors (or raises); :data:`S8_STATS` and :data:`BF16_STATS` count the
launches of each type. The kernel is compiled for the output tiles in
:data:`TILES`; :func:`mm_kernel` takes one by name, :func:`mm` the default.
"""

from __future__ import annotations

import torch

from quickvc_tpu_torch.ops._cuda import KernelStats, check, library, refuse_grad, stream_ptr

S8_STATS = KernelStats("mm_s8")
BF16_STATS = KernelStats("mm_bf16")
TILES = ("128x128", "128x256", "256x128")  # BM x BN, by the C entry's tile index
# the fastest of the sweep at the probe's shape on an H100, in both types
# (python -m quickvc_tpu_torch.scripts.int8_matmul_probe; PERF.md)
DEFAULT_TILE = "256x128"
_KINDS = {torch.int8: ("qvc_mm_s8", torch.int32, 64, S8_STATS),
          torch.bfloat16: ("qvc_mm_bf16", torch.float32, 32, BF16_STATS)}


def mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B: int8 summed exactly into int32, bf16 in float32.

    torch has no int32 matmul on CUDA, so the int8 product is taken in
    float64 and cast: exact while every |sum| < 2**53 (127**2 * K, 2.0e8 at
    the probe's K = 12288). The bf16 product is ``a.float() @ b.float()``,
    full float32 unless the caller turned TF32 on.
    """
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def mm_kernel(a: torch.Tensor, b: torch.Tensor, tile: str = DEFAULT_TILE) -> torch.Tensor:
    """Launch K11 on contiguous CUDA (M, K) and (K, N) of one type, int8 or
    bf16, with K a multiple of 64 (int8) or 32 (bf16) and N of 8."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mm: both inputs must be on one CUDA device, got {a.device} "
                         f"and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _KINDS:
        raise TypeError(f"mm: kernel takes two int8 or two bfloat16 matrices, got "
                        f"{a.dtype} and {b.dtype}")
    fn, out_dtype, k_grain, stats = _KINDS[a.dtype]
    if tile not in TILES:
        raise ValueError(f"mm: tile {tile!r} not in {TILES}")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or a.shape[1] % k_grain or b.shape[1] % 8
            or not (a.is_contiguous() and b.is_contiguous())
            or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"mm: need contiguous 16-byte aligned (M, K) @ (K, N) with K % "
                         f"{k_grain} == 0 and N % 8 == 0, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    check(getattr(library(), fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                                 TILES.index(tile), stream_ptr(a)), f"{fn} kernel")
    stats.launches += 1
    return out


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M, K) @ B (K, N), int8 -> int32 or bf16 -> float32: plain on CPU,
    K11 on CUDA. No backward."""
    refuse_grad("mm", a, b)
    if a.device.type == "cpu":
        return mm_reference(a, b)
    return mm_kernel(a, b)
