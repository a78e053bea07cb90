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

bf16 inputs take the kernels' bf16 mode (``qvc_conv5_lrelu_bf16``,
``qvc_conv5_dw_bf16``: the same implicit GEMM on the bf16 tensor-core core
of ``csrc/bf16_gemm.cuh``, planned on ``BF16_TILING``), as the TPU kernel
computes bf16 operands: products exact in float32, float32 sums, bias and
LeakyReLU, a bf16 output rounded once. Its backward is the JAX VJP's
(``quickvc_tpu/ops/fused_disc_conv.py:136-166``): dym = dy * bf16(lrelu')
rounded to bf16, db the float32 sum of dym rounded to bf16, dx K5 on dym
with the flipped filter, dW K6's float32 sum rounded to bf16 once. At bf16
the CPU runs the same ``autograd.Function`` with the plain forward
(:func:`conv5_lrelu_reference_bf16`) and dW (:func:`conv5_dw_reference`) in
place of the kernels, so both devices round where JAX rounds.
:data:`STATS`/:data:`DW_STATS` count float32 launches,
:data:`BF16_STATS`/:data:`DW_BF16_STATS` bf16 ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (F32_BF16, KernelStats, check, device_sms, library,
                                         require_cuda, require_dtype, stream_ptr)
from quickvc_tpu_torch.ops.fused_transformer import K_TILE, K_TILE_BYTES, TILE_M, TILE_N

K5 = 5
STATS = KernelStats("conv5_lrelu")        # K5 launches: forward and dx
DW_STATS = KernelStats("conv5_lrelu_dw")  # K6 launches
BF16_STATS = KernelStats("conv5_lrelu_bf16")        # K5 bf16 launches: forward and dx
DW_BF16_STATS = KernelStats("conv5_lrelu_dw_bf16")  # K6 bf16 launches


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
    entry = library().qvc_conv5_lrelu_bf16 if bf16 else library().qvc_conv5_lrelu
    check(entry(x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
                y.data_ptr(), n, rows, c_in, c_out, float(slope), stream_ptr(x)),
          "conv5_lrelu kernel")
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
    plan = dw_plan(n, rows, c_in, c_out, device_sms(x.device.index or 0),
                   BF16_TILING if bf16 else F32_TILING)
    dw = torch.empty((K5, c_in, c_out), device=x.device, dtype=dtype)
    ws = (torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
          if plan.workspace else None)
    entry = library().qvc_conv5_dw_bf16 if bf16 else library().qvc_conv5_dw
    check(entry(x.data_ptr(), dym.data_ptr(), dw.data_ptr(),
                None if ws is None else ws.data_ptr(), n, rows, c_in, c_out, plan.splits,
                plan.k_chunk, stream_ptr(x)),
          "conv5_lrelu dW kernel")
    (DW_BF16_STATS if bf16 else DW_STATS).count()
    return dw


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
