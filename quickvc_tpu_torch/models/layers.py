"""Conv layers with the reference's ``state_dict`` keys, channels-first (B, C, T[, W]).

Weight norm keeps explicit ``weight_g``/``weight_v`` parameters, the keys of
the legacy ``torch.nn.utils.weight_norm`` that reference checkpoints carry
(``parametrizations.weight.original0/1`` would not load them), with the
same rule: ``weight = g * v / ||v||``, the norm taken over every dim except
``dim``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def reflection_pad_left(x: torch.Tensor) -> torch.Tensor:
    """torch ReflectionPad1d((1, 0)) on the time axis of (B, C, T)."""
    return F.pad(x, (1, 0), mode="reflect")


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
        return F.conv1d(x, self.weight(), self.bias, self.stride, self.padding,
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
        return F.conv2d(x, self.weight(), self.bias, self.stride, self.padding)


class WNConvTranspose1d(_WeightNorm):
    """``weight_norm(nn.ConvTranspose1d(...))``: weight_v (in, out, k), weight_g (in, 1, 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 padding: int = 0, output_padding: int = 0):
        super().__init__()
        self._init_wn((in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.padding, self.output_padding = stride, padding, output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.weight(), self.bias, self.stride,
                                  self.padding, self.output_padding)
