"""Kernels K5 (k=5 conv + bias + LeakyReLU, and its dx) and K6 (its dW),
``csrc/fused_disc_conv.cu``, behind a ``torch.autograd.Function``.

K5 replaces the TPU kernel ``quickvc_tpu/ops/fused_disc_conv.py:conv5_lrelu``
(forward and dx), K6 its dW ``pallas_call``. With x (N, R, C_in), filter
(5, C_in, C_out), bias (C_out):

  forward  y  = lrelu(sum_dr x[r + dr - 2] @ K[dr] + b)
  dx       K5 on dym with K'[dr] = K[4 - dr]^T and slope 1
  dW       K6: dW[dr] = sum_n x_n[dr - 2 : dr - 2 + R]^T @ dym_n
  db       sum(dym);  dym = dy * lrelu'(y), the mask from the saved output

The plain version, :func:`conv5_lrelu_reference`, is the same five shifted
matmuls in PyTorch (autograd gives its backward). A CPU tensor takes it; a
CUDA tensor launches the kernels or raises. As in the JAX package, the
default discriminator does not route through it: ``DiscriminatorP`` takes
it for its fifth conv only when built with ``fused_conv5=True``.

Both kernels are one implicit GEMM on TF32 tensor cores in 3xTF32. K6 cuts
its reduction over the N*R rows into splits (:func:`dw_plan`), each writing
a float32 partial to a workspace that a second kernel sums in split order:
the same inputs give the same bits on every launch.

bf16 inputs take the kernels' bf16 mode, as the TPU kernel computes bf16
operands: products exact in float32, float32 sums, bias and LeakyReLU, a
bf16 output rounded once. It has two bodies, chosen on the host by shape
before the launch (:func:`takes_wgmma`): the persistent TMA + ``wgmma``
implicit GEMM of ``csrc/conv5_wgmma.cu`` (``qvc_conv5_lrelu_bf16_wgmma``,
``qvc_conv5_dw_bf16_wgmma``, planned by :func:`conv5_wgmma_plan`) for
C_in a multiple of 64, C_out a multiple of 8 and 16-byte aligned tensors,
every period shape among them; the ``mma.sync`` implicit GEMM of
``csrc/fused_disc_conv.cu`` on the core of ``csrc/bf16_gemm.cuh``
(``qvc_conv5_lrelu_bf16``, ``qvc_conv5_dw_bf16``, planned on
``BF16_TILING``) for every other shape the JAX kernel takes. A failed
build or launch raises; neither body stands in for the other. Its
backward is the JAX VJP's
(``quickvc_tpu/ops/fused_disc_conv.py:136-166``): dym = dy * bf16(lrelu')
rounded to bf16, db the float32 sum of dym rounded to bf16, dx K5 on dym
with the flipped filter, dW K6's float32 sum rounded to bf16 once. At bf16
the CPU runs the same ``autograd.Function`` with the plain forward
(:func:`conv5_lrelu_reference_bf16`) and dW (:func:`conv5_dw_reference`) in
place of the kernels, so both devices round where JAX rounds.
:data:`STATS`/:data:`DW_STATS` count float32 launches,
:data:`BF16_STATS`/:data:`DW_BF16_STATS` bf16 ones (either body), and
:data:`WGMMA_STATS`/:data:`DW_WGMMA_STATS` those of the bf16 launches that
ran the ``wgmma`` body.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (F32_BF16, KernelStats, check, device_sms, library,
                                         require_cuda, require_dtype, stream_ptr)
from quickvc_tpu_torch.ops.fused_transformer import (K_TILE, K_TILE_BYTES, TILE_M, TILE_N,
                                                    WgmmaPlan, wgmma_plan)

K5 = 5
STATS = KernelStats("conv5_lrelu")        # K5 launches: forward and dx
DW_STATS = KernelStats("conv5_lrelu_dw")  # K6 launches
BF16_STATS = KernelStats("conv5_lrelu_bf16")        # K5 bf16 launches: forward and dx
DW_BF16_STATS = KernelStats("conv5_lrelu_dw_bf16")  # K6 bf16 launches
WGMMA_STATS = KernelStats("conv5_lrelu_bf16_wgmma")        # of those, on the wgmma body
DW_WGMMA_STATS = KernelStats("conv5_lrelu_dw_bf16_wgmma")


class Tiling(NamedTuple):
    """A GEMM body's tiling: a block computes a tile_m x tile_n output tile
    and walks K in tiles of k_tile (the kernel refuses a split edge off
    them), ``blocks_per_sm`` blocks an SM; ``k_tile_bytes`` is the
    device-memory traffic the card moves in the time one block takes for
    one K tile."""
    tile_m: int
    tile_n: int
    k_tile: int
    blocks_per_sm: int
    k_tile_bytes: float


# The kernels' tilings: the float32 body's (csrc/fused_disc_conv.cu: BM, BN,
# BK, MIN_BLOCKS) is K8's 256 x 128 x 32 at one block an SM
# (ops/fused_transformer.py), the bf16 mode's the bf16 mma.sync core's
# 128 x 128 x 64 at two (csrc/bf16_gemm.cuh: BM, BN, BK, MIN_BLOCKS). The
# bf16 core's time a K tile is not measured yet: this takes the data sheet's
# 989 TFLOP/s dense bf16 rate over 132 SMs, shared by their two blocks, for
# the tile's 2 x 128 x 128 x 64 flops (0.56 us), at 3.35 TB/s.
F32_TILING = Tiling(TILE_M, TILE_N, K_TILE, 1, K_TILE_BYTES)
BF16_TILING = Tiling(128, 128, 64, 2, 3.35e12 * (2 * 128 * 128 * 64) / (989e12 / 132 / 2))
MAX_SPLITS = 4          # workspace at most 4 x dW (80 MB at 1024 -> 1024)
MIN_SPLIT_K_TILES = 8   # K tiles a split walks at least


class DwPlan(NamedTuple):
    """How K6 cuts its reduction over k in [0, N*R): split z takes
    [z * k_chunk, min((z + 1) * k_chunk, N*R)); ``workspace`` floats hold the
    partials (0 for one split, which writes dW directly)."""
    splits: int
    k_chunk: int
    workspace: int


def dw_plan(n: int, rows: int, c_in: int, c_out: int, sm_count: int = 132,
            tiling: Tiling = F32_TILING) -> DwPlan:
    """The split count that fills the card's last wave of blocks best.

    K6's grid is ceil(5 C_in / tile_m) x ceil(C_out / tile_n) tiles, each
    walking all N*R rows; at the discriminator's 1024 -> 1024 that is 160
    tiles on 132 block slots (1.2 waves) in float32, 320 on 264 at bf16.
    Splitting the reduction s ways gives s times the blocks; the plan takes
    the s in 1..MAX_SPLITS whose blocks fill their waves best (ties to the
    smaller s), each split keeping at least MIN_SPLIT_K_TILES K tiles, then
    evens the splits on K-tile edges so that none is empty.
    """
    k = n * rows
    k_tiles = -(-k // tiling.k_tile)
    tiles = -(-(K5 * c_in) // tiling.tile_m) * -(-c_out // tiling.tile_n)
    slots = sm_count * tiling.blocks_per_sm

    def fill(s: int) -> float:
        blocks = tiles * s
        return blocks / (-(-blocks // slots) * slots)

    allowed = [s for s in range(1, MAX_SPLITS + 1) if s == 1 or k_tiles >= s * MIN_SPLIT_K_TILES]
    splits = max(allowed, key=lambda s: (fill(s), -s))
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)
    return DwPlan(splits, per * tiling.k_tile, splits * K5 * c_in * c_out if splits > 1 else 0)


def conv5_gemm(dw: bool, n: int, rows: int, c_in: int, c_out: int) -> tuple[int, int, int]:
    """(M, N, K) of the implicit GEMM: K5 (N R) x C_out over 5 C_in, K6
    (5 C_in) x C_out over N R."""
    return (K5 * c_in, c_out, n * rows) if dw else (n * rows, c_out, K5 * c_in)


# Device seconds a k tile of the wgmma body took with every SM busy, by tile
# width: K5 bf16 at p = 2, x (128, 64, 1024), each width's whole waves of 80
# k tiles (kernel_times.py --only conv5 on an "NVIDIA H100 80GB HBM3,
# 700.00 W"). The bf16 rate alone, with the A tile as 64 more columns
# (fused_transformer.wgmma_cost), put bn 128 at 0.42 us and bn 256 at 0.70:
# the card spends much more on a narrow tile, and chose bn 256 where that
# model chose bn 128 (K5 at p = 7).
CONV5_K_TILE_SECONDS = {64: 0.504e-6, 128: 0.658e-6, 192: 0.752e-6, 256: 0.833e-6}


def conv5_wgmma_plan(dw: bool, n: int, rows: int, c_in: int, c_out: int,
                     sm_count: int = 132) -> WgmmaPlan:
    """The wgmma body's tile width and split (``csrc/conv5_wgmma.cu``): the
    (bn, splits) of least ``fused_transformer.wgmma_cost`` for the implicit
    GEMM, which counts waves of 128 x bn work items on one block an SM, each
    k tile at its time on the card (:data:`CONV5_K_TILE_SECONDS`), and a
    split's float32 partials (written, then read by the sum). K5 never
    splits (its epilogue takes the bias and LeakyReLU on the sums). At the
    period shapes K5 takes bn 256 (256-268 items: two waves, three at p =
    7; bn 128 timed 1.3-1.6x slower), and K6 bn 256 split 3 ways (480-504
    items, four waves of a third of the k tiles, 3 x 21 MB of partials),
    which the card timed 6-7% ahead of bn 192 unsplit at p = 7 and 11 and
    1% behind at p = 2."""
    m, nn, k = conv5_gemm(dw, n, rows, c_in, c_out)
    return wgmma_plan(m, nn, k, sm_count, max_splits=MAX_SPLITS if dw else 1,
                      k_tile_seconds=CONV5_K_TILE_SECONDS)


def takes_wgmma(c_in: int, c_out: int, *tensors: torch.Tensor) -> bool:
    """Whether the bf16 call goes to the wgmma body: C_in a multiple of 64
    (a 64-channel box of x lies in one tap), C_out a multiple of 8 (TMA's
    16-byte rows) and every tensor 16-byte aligned (a bias 4-byte: it is
    read in pairs). Every period shape does; the gathered shapes (channels
    off multiples of 8) and offset views take the ``mma.sync`` body."""
    return (c_in % 64 == 0 and c_out % 8 == 0
            and all(t.data_ptr() % (4 if t.dim() == 1 else 16) == 0 for t in tensors))


def disc_conv5_shapes(batch: int, segment: int, periods=(2, 3, 5, 7, 11),
                      channels: int = 1024) -> dict[int, tuple[int, int, int]]:
    """x (N, R, C) that K5 sees at each period discriminator's fifth conv
    for a (batch, 1, segment) wave: the wave folded to (segment / p, p),
    reflect-padded to whole periods, then four convs of stride 3 and
    padding 2 (R = ceil(. / 3) four times), N = batch * p."""
    out = {}
    for p in periods:
        rows = -(-segment // p)
        for _ in range(4):
            rows = -(-rows // 3)
        out[p] = (batch * p, rows, channels)
    return out


def conv5_lrelu_reference(x: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor | None, slope: float = 0.1) -> torch.Tensor:
    """lrelu(conv1d(x, kernel, 'SAME', stride 1) + bias) as five shifted matmuls."""
    rows = x.shape[1]
    xp = F.pad(x, (0, 0, K5 // 2, K5 // 2))
    y = sum(xp[:, dr : dr + rows] @ kernel[dr] for dr in range(K5))
    if bias is not None:
        y = y + bias
    return torch.where(y > 0, y, slope * y)


def conv5_lrelu_reference_bf16(x: torch.Tensor, kernel: torch.Tensor,
                               bias: torch.Tensor | None, slope: float = 0.1) -> torch.Tensor:
    """K5's bf16 mode in plain PyTorch: the bf16 operands through float32
    matmuls (exact products, float32 sums), the bias and the LeakyReLU in
    float32, the output rounded to ``x``'s dtype once."""
    y = conv5_lrelu_reference(x.float(), kernel.float(),
                              None if bias is None else bias.float(), slope)
    return y.to(x.dtype)


def conv5_dw_reference(x: torch.Tensor, dym: torch.Tensor) -> torch.Tensor:
    """K6 in plain PyTorch: dW[dr] = sum_n x_n[dr - 2 : dr - 2 + R]^T @ dym_n
    in float32 over x (N, R, C_in) and dym (N, R, C_out), rounded to ``x``'s
    dtype once (a no-op in float32)."""
    rows = x.shape[1]
    xp = F.pad(x.float(), (0, 0, K5 // 2, K5 // 2))
    d = dym.float().reshape(-1, dym.shape[2])
    return torch.stack([xp[:, dr : dr + rows].reshape(-1, x.shape[2]).T @ d
                        for dr in range(K5)]).to(x.dtype)


def _require(name: str, *tensors: torch.Tensor) -> torch.dtype:
    dtype = require_cuda(name, *tensors, dtypes=F32_BF16)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous, got strides {t.stride()}")
    return dtype


def conv5_lrelu_kernel(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor | None, slope: float) -> torch.Tensor:
    """Launch K5: x (N, R, C_in), kernel (5, C_in, C_out), bias (C_out) or None,
    all float32 or all bf16 (its bf16 mode); y in x's dtype."""
    dtype = _require("conv5_lrelu", x, kernel, *([] if bias is None else [bias]))
    n, rows, c_in = x.shape
    if kernel.dim() != 3 or kernel.shape[:2] != (K5, c_in) or (
            bias is not None and bias.shape != (kernel.shape[2],)):
        raise ValueError(f"conv5_lrelu: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    c_out = kernel.shape[2]
    bf16 = dtype == torch.bfloat16
    y = torch.empty((n, rows, c_out), device=x.device, dtype=dtype)
    args = (x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), n, rows, c_in, c_out, float(slope))
    if bf16 and takes_wgmma(c_in, c_out, x, kernel, y, *([] if bias is None else [bias])):
        plan = conv5_wgmma_plan(False, n, rows, c_in, c_out, device_sms(x.device.index or 0))
        check(library().qvc_conv5_lrelu_bf16_wgmma(*args, plan.bn, stream_ptr(x)),
              "conv5_lrelu bf16 wgmma kernel")
        WGMMA_STATS.count()
    else:
        entry = library().qvc_conv5_lrelu_bf16 if bf16 else library().qvc_conv5_lrelu
        check(entry(*args, stream_ptr(x)), "conv5_lrelu kernel")
    (BF16_STATS if bf16 else STATS).count()
    return y


def conv5_dw_kernel(x: torch.Tensor, dym: torch.Tensor) -> torch.Tensor:
    """Launch K6: x (N, R, C_in), dym (N, R, C_out) -> dW (5, C_in, C_out), all
    float32 or all bf16 (its bf16 mode: float32 sums, dW rounded once)."""
    dtype = _require("conv5_lrelu dW", x, dym)
    n, rows, c_in = x.shape
    if dym.dim() != 3 or dym.shape[:2] != (n, rows):
        raise ValueError(f"conv5_lrelu dW: x {tuple(x.shape)}, dym {tuple(dym.shape)}")
    c_out = dym.shape[2]
    bf16 = dtype == torch.bfloat16
    sms = device_sms(x.device.index or 0)
    dw = torch.empty((K5, c_in, c_out), device=x.device, dtype=dtype)
    wgmma = bf16 and takes_wgmma(c_in, c_out, x, dym, dw)
    plan = (conv5_wgmma_plan(True, n, rows, c_in, c_out, sms) if wgmma
            else dw_plan(n, rows, c_in, c_out, sms, BF16_TILING if bf16 else F32_TILING))
    ws = (torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
          if plan.workspace else None)
    args = (x.data_ptr(), dym.data_ptr(), dw.data_ptr(), None if ws is None else ws.data_ptr(),
            n, rows, c_in, c_out)
    if wgmma:
        check(library().qvc_conv5_dw_bf16_wgmma(*args, plan.bn, plan.splits, plan.k_chunk,
                                                stream_ptr(x)),
              "conv5_lrelu dW bf16 wgmma kernel")
        DW_WGMMA_STATS.count()
    else:
        entry = library().qvc_conv5_dw_bf16 if bf16 else library().qvc_conv5_dw
        check(entry(*args, plan.splits, plan.k_chunk, stream_ptr(x)), "conv5_lrelu dW kernel")
    (DW_BF16_STATS if bf16 else DW_STATS).count()
    return dw


def conv5_wgmma_attributes(dw: bool, bn: int) -> dict:
    """The wgmma body of K5 (``dw`` False) or K6 at ``bn`` as compiled, on the
    card: blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), a
    thread's registers at launch and local (spill) bytes, a block's dynamic
    shared memory (``cudaFuncGetAttributes``)."""
    out = (ctypes.c_int * 4)()
    check(library().qvc_conv5_wgmma_attributes(int(dw), bn, out), "conv5 wgmma attributes")
    return {"blocks_per_sm": out[0], "registers": out[1], "local_bytes": out[2],
            "smem": out[3]}


def _conv(x, kernel, bias, slope):
    """K5 on a CUDA tensor; on the CPU (bf16) its plain version."""
    if x.device.type == "cpu":
        return conv5_lrelu_reference_bf16(x, kernel, bias, slope)
    return conv5_lrelu_kernel(x, kernel, bias, slope)


def _dw(x, dym):
    """K6 on a CUDA tensor; on the CPU (bf16) its plain version."""
    return conv5_dw_reference(x, dym) if x.device.type == "cpu" else conv5_dw_kernel(x, dym)


class Conv5LReLU(torch.autograd.Function):
    """K5 forward; backward = K5 on the flipped filter (dx) + K6 (dW) + db,
    rounded where the JAX VJP rounds (in bf16: dym, dx, dW, db)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, slope):
        y = _conv(x, kernel, bias, slope)
        ctx.save_for_backward(x, kernel, y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, y = ctx.saved_tensors
        # lrelu' from the saved OUTPUT (lrelu keeps the sign of its input), in
        # dy's dtype as JAX casts it (bf16: a slope of bf16(0.1)), one rounding
        dym = (dy * torch.where(y > 0, 1.0, ctx.slope).to(dy.dtype)).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            k_flip = kernel.flip(0).transpose(1, 2).contiguous()   # (5, C_out, C_in)
            dx = _conv(dym, k_flip, None, 1.0)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, dym)
        if ctx.needs_input_grad[2]:
            db = dym.float().sum(dim=(0, 1)).to(kernel.dtype)
        return dx, dw, db, None


def conv5_lrelu(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                slope: float = 0.1) -> torch.Tensor:
    """(N, R, C_in) -> (N, R, C_out), x, kernel and bias all float32 or all
    bf16: K5/K6 on CUDA (their bf16 mode at bf16); on the CPU the plain
    version, through autograd in float32 and through the kernels' own
    backward at bf16. Other dtypes raise TypeError."""
    dtype = require_dtype("conv5_lrelu", *(t for t in (x, kernel, bias) if t is not None),
                          dtypes=F32_BF16)
    if x.device.type == "cpu" and dtype == torch.float32:
        return conv5_lrelu_reference(x, kernel, bias, slope)
    return Conv5LReLU.apply(x, kernel, bias, slope)
