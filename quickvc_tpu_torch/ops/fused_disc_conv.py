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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from quickvc_tpu_torch.ops._cuda import (KernelStats, check, device_sms, library,
                                         require_cuda_f32, stream_ptr)

K5 = 5
STATS = KernelStats("conv5_lrelu")        # K5 launches: forward and dx
DW_STATS = KernelStats("conv5_lrelu_dw")  # K6 launches

# The kernels' tiling (csrc/fused_disc_conv.cu: BM, BN, BK, MIN_BLOCKS): a
# block computes a TILE_M x TILE_N output tile, walks K in tiles of K_TILE
# (the kernel refuses a split edge off them), one block an SM.
TILE_M, TILE_N = 256, 128
K_TILE = 32
BLOCKS_PER_SM = 1
MAX_SPLITS = 4          # workspace at most 4 x dW (80 MB at 1024 -> 1024)
MIN_SPLIT_K_TILES = 8   # K tiles a split walks at least


class DwPlan(NamedTuple):
    """How K6 cuts its reduction over k in [0, N*R): split z takes
    [z * k_chunk, min((z + 1) * k_chunk, N*R)); ``workspace`` floats hold the
    partials (0 for one split, which writes dW directly)."""
    splits: int
    k_chunk: int
    workspace: int


def dw_plan(n: int, rows: int, c_in: int, c_out: int, sm_count: int = 132) -> DwPlan:
    """The split count that fills the card's last wave of blocks best.

    K6's grid is ceil(5 C_in / TILE_M) x ceil(C_out / TILE_N) tiles, each
    walking all N*R rows; at the discriminator's 1024 -> 1024 that is 160
    tiles on 132 block slots, 1.2 waves. Splitting the reduction s ways gives
    160 s blocks; the plan takes the s in 1..MAX_SPLITS whose blocks fill
    their waves best (ties to the smaller s), each split keeping at least
    MIN_SPLIT_K_TILES K tiles, then evens the splits on K-tile edges so that
    none is empty.
    """
    k = n * rows
    k_tiles = -(-k // K_TILE)
    tiles = -(-(K5 * c_in) // TILE_M) * -(-c_out // TILE_N)
    slots = sm_count * BLOCKS_PER_SM

    def fill(s: int) -> float:
        blocks = tiles * s
        return blocks / (-(-blocks // slots) * slots)

    allowed = [s for s in range(1, MAX_SPLITS + 1) if s == 1 or k_tiles >= s * MIN_SPLIT_K_TILES]
    splits = max(allowed, key=lambda s: (fill(s), -s))
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)
    return DwPlan(splits, per * K_TILE, splits * K5 * c_in * c_out if splits > 1 else 0)


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


def _require(name: str, *tensors: torch.Tensor) -> None:
    require_cuda_f32(name, *tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous, got strides {t.stride()}")


def conv5_lrelu_kernel(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor | None, slope: float) -> torch.Tensor:
    """Launch K5: x (N, R, C_in), kernel (5, C_in, C_out), bias (C_out) or None."""
    _require("conv5_lrelu", x, kernel, *([] if bias is None else [bias]))
    n, rows, c_in = x.shape
    if kernel.dim() != 3 or kernel.shape[:2] != (K5, c_in) or (
            bias is not None and bias.shape != (kernel.shape[2],)):
        raise ValueError(f"conv5_lrelu: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    c_out = kernel.shape[2]
    y = torch.empty((n, rows, c_out), device=x.device, dtype=torch.float32)
    check(library().qvc_conv5_lrelu(
        x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), n, rows, c_in, c_out, float(slope), stream_ptr(x)),
        "conv5_lrelu kernel")
    STATS.count()
    return y


def conv5_dw_kernel(x: torch.Tensor, dym: torch.Tensor) -> torch.Tensor:
    """Launch K6: x (N, R, C_in), dym (N, R, C_out) -> dW (5, C_in, C_out)."""
    _require("conv5_lrelu dW", x, dym)
    n, rows, c_in = x.shape
    if dym.dim() != 3 or dym.shape[:2] != (n, rows):
        raise ValueError(f"conv5_lrelu dW: x {tuple(x.shape)}, dym {tuple(dym.shape)}")
    c_out = dym.shape[2]
    plan = dw_plan(n, rows, c_in, c_out, device_sms(x.device.index or 0))
    dw = torch.empty((K5, c_in, c_out), device=x.device, dtype=torch.float32)
    ws = (torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
          if plan.workspace else None)
    check(library().qvc_conv5_dw(x.data_ptr(), dym.data_ptr(), dw.data_ptr(),
                                 None if ws is None else ws.data_ptr(), n, rows, c_in,
                                 c_out, plan.splits, plan.k_chunk, stream_ptr(x)),
          "conv5_lrelu dW kernel")
    DW_STATS.count()
    return dw


class Conv5LReLU(torch.autograd.Function):
    """K5 forward; backward = K5 on the flipped filter (dx) + K6 (dW) + db."""

    @staticmethod
    def forward(ctx, x, kernel, bias, slope):
        y = conv5_lrelu_kernel(x, kernel, bias, slope)
        ctx.save_for_backward(x, kernel, y)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, y = ctx.saved_tensors
        # lrelu' from the saved OUTPUT: lrelu keeps the sign of its input
        dym = (dy * torch.where(y > 0, 1.0, ctx.slope)).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            k_flip = kernel.flip(0).transpose(1, 2).contiguous()   # (5, C_out, C_in)
            dx = conv5_lrelu_kernel(dym, k_flip, None, 1.0)
        if ctx.needs_input_grad[1]:
            dw = conv5_dw_kernel(x, dym)
        if ctx.needs_input_grad[2]:
            db = dym.sum(dim=(0, 1))
        return dx, dw, db, None


def conv5_lrelu(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                slope: float = 0.1) -> torch.Tensor:
    """(N, R, C_in) -> (N, R, C_out): plain on CPU, K5/K6 on CUDA."""
    if x.device.type == "cpu":
        return conv5_lrelu_reference(x, kernel, bias, slope)
    return Conv5LReLU.apply(x, kernel, bias, slope)
