"""The three iSTFT decoders, reference layout, channels-first (B, C, T).

Port of ``quickvc_tpu/models/decoders.py`` (reference ``models.py:98-415``):

- ``MultistreamISTFTGenerator`` (``ms_istft_vits``, the default): the polar
  iSTFT head per band, zero-stuffing x subbands through the
  ``updown_filter`` transposed conv and the learned 63-tap
  ``multistream_conv_post``;
- ``MultibandISTFTGenerator`` (``mb_istft_vits``): the same head, the bands
  combined by the fixed PQMF synthesis (:mod:`quickvc_tpu_torch.dsp.pqmf`);
- ``ISTFTGenerator`` (``istft_vits``): one band, ``conv_post`` straight to
  the head.

All share the trunk: conv_pre(k=7) + speaker ``cond``, ConvTranspose
upsamplings with MRF ResBlocks, LReLU(0.01), left reflection pad. The
single-band decoder pads its upsamplings ``(k - u) // 2`` with no
output_padding (reference ``models.py:127-128``), the others ``(k - u + 1 -
i) // 2`` with output_padding ``1 - i`` (``models.py:334-335``).

Each ``forward(x, g, *, differentiable)`` runs the head as the plain
:func:`quickvc_tpu_torch.dsp.istft.polar_inverse_stft` when
``differentiable`` (training: autograd differentiates it, as the JAX
training step runs its XLA head) and dispatches it to kernel K3 otherwise
(inference; on a CUDA tensor the kernel launches or the call raises). The
trunk computes in ``x``'s dtype; the head takes its spectra in float32
whatever that dtype (``quickvc_tpu/dsp/istft.py:114-115``), so the outputs
are float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.dsp import pqmf
from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as polar_inverse_stft_plain
from quickvc_tpu_torch.models.layers import (Conv1d, WNConv1d, WNConvTranspose1d,
                                             leaky_relu, reflection_pad_left)
from quickvc_tpu_torch.models.modules import ResBlock1
from quickvc_tpu_torch.ops.fused_istft import polar_inverse_stft


class _UpMRFGenerator(nn.Module):
    """The trunk and head shared by the three decoders; ``self.channels`` is
    the trunk's output width, ``self.bands`` the number of waves the head
    writes (``subbands``, or 1 for the single-band decoder)."""

    def __init__(self, initial_channel: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gen_istft_n_fft: int,
                 gen_istft_hop_size: int, subbands: int, gin_channels: int,
                 istft_style_padding: bool = False):
        super().__init__()
        self.subbands = subbands
        self.num_kernels = len(resblock_kernel_sizes)
        self.n_fft, self.hop = gen_istft_n_fft, gen_istft_hop_size
        uic = upsample_initial_channel
        self.conv_pre = WNConv1d(initial_channel, uic, 7, padding=3)
        self.cond = Conv1d(gin_channels, uic, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = uic // (2 ** (i + 1))
            pad, outpad = ((k - u) // 2, 0) if istft_style_padding else ((k - u + 1 - i) // 2,
                                                                        1 - i)
            self.ups.append(WNConvTranspose1d(uic // (2 ** i), ch, k, u, padding=pad,
                                              output_padding=outpad))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.channels = ch
        self.upsampling = math.prod(upsample_rates)

    @property
    def bands(self) -> int:
        return self.subbands

    @property
    def samples_per_frame(self) -> int:
        """Output samples a latent frame: the upsampling, the head's hop, the bands."""
        return self.upsampling * self.hop * self.bands

    def trunk(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """(B, inter, F) x (B, gin, 1) -> (B, channels, F * prod(upsample_rates)),
        left reflection-padded for the post conv."""
        x = self.conv_pre(x) + self.cond(g)
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            blocks = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
            x = sum(rb(x) for rb in blocks) / self.num_kernels
        return reflection_pad_left(leaky_relu(x, 0.01))

    def head(self, x: torch.Tensor, differentiable: bool) -> torch.Tensor:
        """Band-major post-conv channels (B, bands * 2 * n_freq, F) -> waves
        (B, bands, hop * (F - 1)): the bands fold into the head's rows, which
        read these strided views in place, (B * bands, F, n_freq)."""
        b, _, f = x.shape
        n_freq = self.n_fft // 2 + 1
        spec = x.view(b * self.bands, 2 * n_freq, f).transpose(1, 2)
        run = polar_inverse_stft_plain if differentiable else polar_inverse_stft
        wave = run(spec[..., :n_freq].float(), spec[..., n_freq:].float(), self.n_fft, self.hop)
        return wave.view(b, self.bands, -1)


class MultistreamISTFTGenerator(_UpMRFGenerator):
    """(B, inter, F) latent x (B, gin, 1) speaker -> (wave (B, 1, T), streams (B, s, T))."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        s = self.subbands
        self.subband_conv_post = WNConv1d(self.channels, s * (self.n_fft + 2), 7, padding=3)
        updown = torch.zeros(s, s, s)
        for k in range(s):
            updown[k, k, 0] = 1.0
        self.register_buffer("updown_filter", updown)
        self.multistream_conv_post = WNConv1d(s, 1, 63, padding=31, bias=False)

    def forward(self, x: torch.Tensor, g: torch.Tensor, *, differentiable: bool):
        s = self.subbands
        y_mb = self.head(self.subband_conv_post(self.trunk(x, g)), differentiable)
        y_mb = F.conv_transpose1d(y_mb, self.updown_filter * s, stride=s)
        return self.multistream_conv_post(y_mb), y_mb


class MultibandISTFTGenerator(_UpMRFGenerator):
    """(B, inter, F) x (B, gin, 1) -> (wave (B, 1, s * T'), bands before the
    PQMF synthesis (B, s, T')), the bands the sub-band STFT loss reads."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.subband_conv_post = WNConv1d(self.channels, self.subbands * (self.n_fft + 2), 7,
                                          padding=3)

    def forward(self, x: torch.Tensor, g: torch.Tensor, *, differentiable: bool):
        y_mb = self.head(self.subband_conv_post(self.trunk(x, g)), differentiable)
        return pqmf.synthesis(y_mb), y_mb


class ISTFTGenerator(_UpMRFGenerator):
    """(B, inter, F) x (B, gin, 1) -> (wave (B, 1, T), None): one band."""

    bands = 1

    def __init__(self, *args, **kwargs):
        super().__init__(*args, istft_style_padding=True, **kwargs)
        self.conv_post = WNConv1d(self.channels, self.n_fft + 2, 7, padding=3)

    def forward(self, x: torch.Tensor, g: torch.Tensor, *, differentiable: bool):
        return self.head(self.conv_post(self.trunk(x, g)), differentiable), None


DECODERS = {"ms_istft": MultistreamISTFTGenerator, "mb_istft": MultibandISTFTGenerator,
            "istft": ISTFTGenerator}


def build_decoder(m) -> _UpMRFGenerator:
    """The decoder ``m.decoder_kind`` names (reference ``models.py:588-591``)."""
    return DECODERS[m.decoder_kind](
        m.inter_channels, m.resblock_kernel_sizes, m.resblock_dilation_sizes,
        m.upsample_rates, m.upsample_initial_channel, m.upsample_kernel_sizes,
        m.gen_istft_n_fft, m.gen_istft_hop_size, m.subbands, m.gin_channels)

