"""Kernel K11: a TMA + wgmma GEMM, s8 x s8 -> s32 and bf16 x bf16 -> f32 (``csrc/int8_mm.cu``).

Replaces the TPU kernel ``scripts/int8_matmul_probe.py:pallas_mm``, which
probes whether a hand-written kernel reaches the chip's int8 rate. A and B
are row-major (M, K) and (K, N). :func:`mm` takes the plain version,
:func:`mm_reference`, for CPU tensors and launches the kernel for CUDA
tensors (or raises); :data:`S8_STATS` and :data:`BF16_STATS` count one
launch a call. The kernel is persistent, one block an SM walking the output
tiles in the order :func:`tile_schedule` gives (the host twin of the
kernel's ``Schedule``). bf16 reads B as it lies (wgmma's transpose-B mode);
s8 takes a pre-pass first, :func:`transpose_b`, which writes B^T (N, K)
into scratch (wgmma reads 8-bit operands K-major only), so an s8 call is two
CUDA launches. The GEMM is compiled for the output tiles in :data:`TILES`;
:func:`mm_kernel` takes one by name, :func:`mm` the default.
"""

from __future__ import annotations

import torch

from quickvc_tpu_torch.ops._cuda import KernelStats, check, library, refuse_grad, stream_ptr

S8_STATS = KernelStats("mm_s8")
BF16_STATS = KernelStats("mm_bf16")
TILES = ("128x256", "128x128")  # BM x BN, by the C entry's tile index
# the fastest of the sweep at the probe's shape on an H100, in both types
# (python -m quickvc_tpu_torch.scripts.int8_matmul_probe; PERF.md)
DEFAULT_TILE = "128x256"
GROUP_M = 16   # tile rows a raster group (csrc/int8_mm.cu:GROUP_M)
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


def tile_schedule(m: int, n: int, tile: str, blocks: int) -> list[list[tuple[int, int]]]:
    """The (row, col) origins of the output tiles each block of K11's
    persistent grid computes, in order: the grid has min(blocks, tiles)
    blocks, block b takes tiles b, b + grid, b + 2 grid, ..., and tile t
    lies in a group of :data:`GROUP_M` tile rows (fewer in the last group),
    walked column by column, the rows of a column one after another. The
    kernel computes the same (``csrc/tma_wgmma.cuh:Schedule``, one split)."""
    bm, bn = (int(x) for x in tile.split("x"))
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    total = tiles_m * tiles_n

    def origin(t: int) -> tuple[int, int]:
        g, local = divmod(t, GROUP_M * tiles_n)
        rows = min(tiles_m - g * GROUP_M, GROUP_M)
        return (g * GROUP_M + local % rows) * bm, local // rows * bn

    grid = min(blocks, total)
    return [[origin(t) for t in range(b, total, grid)] for b in range(grid)]


def transpose_b(b: torch.Tensor) -> torch.Tensor:
    """K11's s8 pre-pass alone: contiguous CUDA (K, N) int8 -> B^T (N, K)."""
    if b.device.type != "cuda" or b.dtype != torch.int8 or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"mm: transpose takes a contiguous CUDA (K, N) int8 matrix, "
                         f"got {tuple(b.shape)} {b.dtype} on {b.device}")
    k, n = b.shape
    bt = torch.empty((n, k), device=b.device, dtype=b.dtype)
    check(library().qvc_mm_transpose(b.data_ptr(), bt.data_ptr(), k, n, stream_ptr(b)),
          "mm transpose kernel")
    return bt


def _operands(a: torch.Tensor, b: torch.Tensor):
    """Check K11's operands; return (C entry, C, the B operand, stats)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mm: both inputs must be on one CUDA device, got {a.device} "
                         f"and {b.device}")
    if a.dtype != b.dtype or a.dtype not in _KINDS:
        raise TypeError(f"mm: kernel takes two int8 or two bfloat16 matrices, got "
                        f"{a.dtype} and {b.dtype}")
    fn, out_dtype, k_grain, stats = _KINDS[a.dtype]
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or a.shape[1] % k_grain or b.shape[1] % 8
            or not (a.is_contiguous() and b.is_contiguous())
            or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError(f"mm: need contiguous 16-byte aligned (M, K) @ (K, N) with K % "
                         f"{k_grain} == 0 and N % 8 == 0, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out = torch.empty((a.shape[0], b.shape[1]), device=a.device, dtype=out_dtype)
    return fn, out, transpose_b(b) if a.dtype == torch.int8 else b, stats


def mm_kernel(a: torch.Tensor, b: torch.Tensor, tile: str = DEFAULT_TILE) -> torch.Tensor:
    """Launch K11 on contiguous CUDA (M, K) and (K, N) of one type, int8 or
    bf16, with K a multiple of 64 (int8) or 32 (bf16) and N of 8."""
    if tile not in TILES:
        raise ValueError(f"mm: tile {tile!r} not in {TILES}")
    fn, out, b_op, stats = _operands(a, b)
    (m, k), n = a.shape, b.shape[1]
    check(getattr(library(), fn)(a.data_ptr(), b_op.data_ptr(), out.data_ptr(), m, n, k,
                                 TILES.index(tile), stream_ptr(a)),
          f"{fn} kernel")
    stats.count()
    return out


# K11's bring-up probes of the default tile (csrc/int8_mm.cu:qvc_mm_probe):
# the product, the mainloop without the store, the tensor cores on stale
# shared memory (nothing loaded or stored), and for bf16 the body without its
# accumulator fences (whose sums come out short)
_PROBES = {"product": 0, "no_store": 1, "no_load": 3, "no_operand_fence": 4}


def _mm_probe(a: torch.Tensor, b: torch.Tensor, probe: str, blocks: int = 0) -> torch.Tensor:
    """One of :data:`_PROBES` on ``mm_kernel``'s operands (``scripts/kernel_times.py``),
    on a persistent grid of ``blocks`` blocks (0: one an SM). Counts no launch:
    only ``"product"`` computes the product; the no-store probes return a C
    that holds none, ``"no_operand_fence"`` one that is wrong."""
    fn, out, b_op, _ = _operands(a, b)
    (m, k), n = a.shape, b.shape[1]
    check(library().qvc_mm_probe(int(a.dtype == torch.bfloat16), _PROBES[probe], a.data_ptr(),
                                 b_op.data_ptr(), out.data_ptr(), m, n, k, blocks,
                                 stream_ptr(a)),
          f"{fn} probe {probe}")
    return out


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (M, K) @ B (K, N), int8 -> int32 or bf16 -> float32: plain on CPU,
    K11 on CUDA. No backward."""
    refuse_grad("mm", a, b)
    if a.device.type == "cpu":
        return mm_reference(a, b)
    return mm_kernel(a, b)
