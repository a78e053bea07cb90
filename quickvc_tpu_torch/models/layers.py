"""Conv layers with the reference's ``state_dict`` keys, channels-first (B, C, T[, W]).

Weight norm keeps explicit ``weight_g``/``weight_v`` parameters, the keys of
the legacy ``torch.nn.utils.weight_norm`` that reference checkpoints carry
(``parametrizations.weight.original0/1`` would not load them), with the
same rule: ``weight = g * v / ||v||``, the norm taken over every dim except
``dim``.

Compute dtype, as the JAX layers have it (``quickvc_tpu/models/layers.py``):
parameters stay float32, and each layer casts its (weight-normed) weight
and its bias to the input's dtype where it uses them, so a bf16 input runs
the layer in bf16 while gradients and optimizer moments stay float32. A
float32 input is untouched (the casts are no-ops).

On the card a bf16 convolution is cuDNN's: bf16 operands, float32 sums, the
output rounded to bf16 once. Torch's CPU backends do not all compute that
(oneDNN's bf16 transposed convolution gives wrong input gradients on some
CPUs; the native path rounds partial sums), so on the CPU :func:`conv` takes
the bf16-rounded operands through a float32 convolution and rounds its
output to bf16 once: the card's arithmetic, which the CPU tests hold
against the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.dsp.stft import reflect_pad

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def cast_like(x: torch.Tensor, *params: torch.Tensor | None) -> list[torch.Tensor | None]:
    """``params`` in ``x``'s dtype (None stays None)."""
    return [None if p is None else p.to(x.dtype) for p in params]


def conv(fn, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
         *args) -> torch.Tensor:
    """``fn(x, weight, bias, *args)``, a ``torch.nn.functional`` convolution, in
    ``x``'s dtype (see the module's note on bf16 on the CPU)."""
    w, b = cast_like(x, weight, bias)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return fn(x.float(), w.float(), None if b is None else b.float(), *args).to(x.dtype)
    return fn(x, w, b, *args)


def norm_like(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm or GroupNorm in float32 on ``x`` upcast, returned in ``x``'s
    dtype, as the JAX package's ``norm_like`` (``models/hubert.py:37-45``)."""
    return norm(x.float()).to(x.dtype)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` (same keys) computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv1d, x, self.weight, self.bias, self.stride, self.padding,
                    self.dilation, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` (same keys) computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *cast_like(x, self.weight, self.bias))


def reflection_pad_left(x: torch.Tensor) -> torch.Tensor:
    """torch ReflectionPad1d((1, 0)) on the time axis of (B, C, T)."""
    return reflect_pad(x, 1, 0)


class _WeightNorm(nn.Module):
    """Holds ``weight_g``/``weight_v`` and forms the normalized weight."""

    def _init_wn(self, shape: tuple[int, ...], norm_dim: int = 0) -> None:
        self.norm_dim = norm_dim
        self.weight_v = nn.Parameter(torch.empty(shape))
        g_shape = [1] * len(shape)
        g_shape[self.norm_dim] = shape[self.norm_dim]
        self.weight_g = nn.Parameter(torch.ones(g_shape))

    def weight(self) -> torch.Tensor:
        dims = [d for d in range(self.weight_v.dim()) if d != self.norm_dim]
        norm = torch.linalg.vector_norm(self.weight_v, dim=dims, keepdim=True)
        return self.weight_v * (self.weight_g / norm)


class WNConv1d(_WeightNorm):
    """``weight_norm(nn.Conv1d(...), dim=norm_dim)``: weight_v (out, in/groups, k),
    weight_g (out, 1, 1) for the default ``norm_dim=0``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = True, norm_dim: int = 0):
        super().__init__()
        self._init_wn((out_ch, in_ch // groups, kernel_size), norm_dim)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv1d, x, self.weight(), self.bias, self.stride, self.padding,
                    self.dilation, self.groups)


class WNConv2d(_WeightNorm):
    """``weight_norm(nn.Conv2d(...))``: weight_v (out, in, kh, kw), weight_g (out, 1, 1, 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0)):
        super().__init__()
        self._init_wn((out_ch, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv2d, x, self.weight(), self.bias, self.stride, self.padding)


class WNConvTranspose1d(_WeightNorm):
    """``weight_norm(nn.ConvTranspose1d(...))``: weight_v (in, out, k), weight_g (in, 1, 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 padding: int = 0, output_padding: int = 0):
        super().__init__()
        self._init_wn((in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.output_padding = stride, padding, output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv_transpose1d, x, self.weight(), self.bias, self.stride,
                    self.padding, self.output_padding)
