"""WaveNet, HiFi-GAN ResBlock1, flow and CondNormalWN with the reference's keys.

Ports of ``quickvc_tpu/models/modules.py``, laid out as the reference
(``modules.py:37-224``, ``models.py:17-95``) so its checkpoints load:
per-layer ``in_layers``/``res_skip_layers`` (the last res/skip layer is h
wide, skip only), ``flow.flows.{2i}`` couplings interleaved with Flips.
Tensors are channels-first (B, C, T). Every block computes in its input's
dtype (float32 parameters cast where used, ``layers.py``): the WaveNet's
skip sum starts as zeros of that dtype and the posterior noise is drawn in
it, as the JAX modules do (``quickvc_tpu/models/modules.py:81, 200``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from quickvc_tpu_torch.models.layers import Conv1d, WNConv1d, get_padding, leaky_relu


class WN(nn.Module):
    """Non-causal WaveNet: gated tanh/sigmoid units, global conditioning, skip sum."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels, self.n_layers = h, n_layers
        if gin_channels:
            self.cond_layer = WNConv1d(gin_channels, 2 * h * n_layers, 1)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(WNConv1d(h, 2 * h, kernel_size, dilation=d,
                                           padding=get_padding(kernel_size, d)))
            self.res_skip_layers.append(WNConv1d(h, 2 * h if i < n_layers - 1 else h, 1))

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        h = self.hidden_channels
        output = torch.zeros_like(x)
        if g is not None:
            g = self.cond_layer(g)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g is not None:
                x_in = x_in + g[:, i * 2 * h : (i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = x + res_skip[:, :h]
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output


class ResBlock1(nn.Module):
    """HiFi-GAN MRF block: 3 x [LReLU, dilated conv, LReLU, conv] with residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, dilation=d,
                     padding=get_padding(kernel_size, d)) for d in dilation)
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size))
            for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(leaky_relu(c1(leaky_relu(x))))
        return x


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling: x1' = x1 +/- post(WN(pre(x0), g))."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        x0, x1 = x[:, : self.half], x[:, self.half :]
        m = self.post(self.enc(self.pre(x0), g))
        x1 = x1 - m if reverse else x1 + m
        return torch.cat([x0, x1], dim=1)


class Flip(nn.Module):
    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        return torch.flip(x, [1])


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling, Flip); ``reverse=True`` runs the chain backwards."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                                    dilation_rate, n_layers, gin_channels))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                reverse: bool = False) -> torch.Tensor:
        for flow in (reversed(self.flows) if reverse else self.flows):
            x = flow(x, g, reverse=reverse)
        return x


class CondNormalWN(nn.Module):
    """Conditional Gaussian: pre conv -> WN -> proj to (mu, logs); returns (z, mu, logs)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                noise_scale: float = 1.0, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None):
        """``eps`` replaces the standard-normal draw (tests inject the JAX
        package's noise through it); drawn or given, the noise takes ``mu``'s
        dtype."""
        stats = self.proj(self.enc(self.pre(x), g))
        mu, logs = stats[:, : self.out_channels], stats[:, self.out_channels :]
        if noise_scale == 0.0:
            return mu, mu, logs
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        return mu + eps.to(mu.dtype) * torch.exp(logs) * noise_scale, mu, logs
