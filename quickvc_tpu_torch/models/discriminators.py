"""HiFi-GAN discriminators (MPD = 1 x scale + 5 x period), reference layout.

Port of ``quickvc_tpu/models/discriminators.py`` in the reference's own
module tree (``models.py:418-504``), so a reference ``D_*.pth`` loads with
``strict=True``: ``discriminators.0`` is the scale discriminator,
``discriminators.{1..5}`` the period ones, each with ``convs.{i}`` and
``conv_post`` weight-normed. Waveforms are channels-first (B, 1, T); a
period discriminator folds them to (B, 1, T/p, p). Convolutions are cuDNN's,
as the JAX package leaves them to ``lax.conv``.

``width`` scales the channel ladders as in the JAX package (tests use narrow
stacks). ``fused_conv5=True`` routes each period discriminator's fifth conv
(C -> C, (5, 1), stride 1) through kernels K5/K6
(:mod:`quickvc_tpu_torch.ops.fused_disc_conv`); it is off by default, as in
the JAX package.

Each conv computes in its input's dtype (float32 parameters cast where
used, as ``quickvc_tpu/models/discriminators.py:43-49``); the training step
feeds bf16 waves at ``precision: "bf16"``. The fused fifth conv casts its
weight-normed kernel and its bias the same way, so a bf16 wave runs K5/K6
in their bf16 mode and the float32 parameters get float32 gradients back
through the cast.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.models.layers import (LRELU_SLOPE, WNConv1d, WNConv2d, cast_like,
                                             get_padding, leaky_relu)
from quickvc_tpu_torch.ops.fused_disc_conv import conv5_lrelu


class DiscriminatorP(nn.Module):
    """Period discriminator: fold the wave to (T/p, p), 5-conv (k, 1) stack + post."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 width: float = 1.0, fused_conv5: bool = False):
        super().__init__()
        if fused_conv5 and kernel_size != 5:
            raise ValueError(f"fused_conv5 needs kernel_size 5, got {kernel_size}")
        self.period = period
        self.fused_conv5 = fused_conv5
        chans = [max(4, int(c * width)) for c in (32, 128, 512, 1024)]
        pad = (get_padding(kernel_size), 0)
        ins = [1] + chans
        self.convs = nn.ModuleList(
            [WNConv2d(i, o, (kernel_size, 1), (stride, 1), pad)
             for i, o in zip(ins[:-1], chans)]
            + [WNConv2d(chans[-1], chans[-1], (kernel_size, 1), (1, 1), pad)])
        self.conv_post = WNConv2d(chans[-1], 1, (3, 1), (1, 1), (1, 0))

    def _fused_last(self, x: torch.Tensor) -> torch.Tensor:
        """The fifth conv + LReLU as K5: (B, C, H, W) <-> (B*W, H, C) rows."""
        conv = self.convs[-1]
        b, c, h, w = x.shape
        kernel = conv.weight()[..., 0].permute(2, 1, 0).contiguous()  # (5, C_in, C_out)
        rows = x.permute(0, 3, 2, 1).reshape(b * w, h, c).contiguous()
        y = conv5_lrelu(rows, *cast_like(x, kernel, conv.bias), LRELU_SLOPE)
        return y.reshape(b, w, h, -1).permute(0, 3, 2, 1)

    def forward(self, x: torch.Tensor):
        fmap = []
        b, c, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
            t = x.shape[-1]
        x = x.view(b, c, t // p, p)
        for i, conv in enumerate(self.convs):
            if self.fused_conv5 and i == len(self.convs) - 1:
                x = self._fused_last(x)
            else:
                x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped wide-kernel Conv1d stack + post."""

    SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))

    def __init__(self, width: float = 1.0):
        super().__init__()
        convs, in_ch = [], 1
        for ch, k, s, groups, pad in self.SPECS:
            ch = int(ch * width)
            convs.append(WNConv1d(in_ch, ch, k, stride=s, padding=pad, groups=groups))
            in_ch = ch
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv1d(in_ch, 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """DiscriminatorS + DiscriminatorP for periods (2, 3, 5, 7, 11).

    ``pair=True`` runs each sub-discriminator once on real‖fake concatenated
    along the batch (both halves need parameter gradients: the D phase);
    ``pair=False`` runs them apart (only the fake half is differentiated:
    the G phase), as ``quickvc_tpu/models/discriminators.py:116-157`` does.
    """

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), width: float = 1.0,
                 fused_conv5: bool = False):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(width)]
            + [DiscriminatorP(p, width=width, fused_conv5=fused_conv5) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, pair: bool = True):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        b = y.shape[0]
        for d in self.discriminators:
            if pair:
                logit, fmap = d(torch.cat([y, y_hat], dim=0))
                logit_r, logit_g = logit[:b], logit[b:]
                fmap_r, fmap_g = [f[:b] for f in fmap], [f[b:] for f in fmap]
            else:
                (logit_r, fmap_r), (logit_g, fmap_g) = d(y), d(y_hat)
            y_d_rs.append(logit_r)
            y_d_gs.append(logit_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
