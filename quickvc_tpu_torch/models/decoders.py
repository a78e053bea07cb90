"""Multistream iSTFT decoder (the default ``ms_istft_vits``), reference layout.

Port of ``quickvc_tpu/models/decoders.py:MultistreamISTFTGenerator``
(reference ``models.py:304-415``): conv_pre(k=7) + speaker ``cond``, two
ConvTranspose upsamplings with MRF ResBlocks, LReLU(0.01), left reflection
pad, ``subband_conv_post`` to ``subbands * 2 * (n_fft/2+1)`` band-major
channels, the polar iSTFT head per band (kernel K3 on the card at inference, the
differentiable plain version in training), then
zero-stuffing x subbands through the ``updown_filter`` transposed conv and
the learned 63-tap ``multistream_conv_post``. Channels-first (B, C, T).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as polar_inverse_stft_plain
from quickvc_tpu_torch.models.layers import (Conv1d, WNConv1d, WNConvTranspose1d,
                                             leaky_relu, reflection_pad_left)
from quickvc_tpu_torch.models.modules import ResBlock1
from quickvc_tpu_torch.ops.fused_istft import polar_inverse_stft


class MultistreamISTFTGenerator(nn.Module):
    """(B, inter, F) latent x (B, gin, 1) speaker -> (wave (B, 1, T), streams (B, s, T))."""

    def __init__(self, initial_channel: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gen_istft_n_fft: int,
                 gen_istft_hop_size: int, subbands: int, gin_channels: int):
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
            # reference models.py:334-335: padding (k-u+1-i)//2, output_padding 1-i
            self.ups.append(WNConvTranspose1d(uic // (2 ** i), ch, k, u,
                                              padding=(k - u + 1 - i) // 2,
                                              output_padding=1 - i))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.subband_conv_post = WNConv1d(ch, subbands * (gen_istft_n_fft + 2), 7, padding=3)
        updown = torch.zeros(subbands, subbands, subbands)
        for k in range(subbands):
            updown[k, k, 0] = 1.0
        self.register_buffer("updown_filter", updown)
        self.multistream_conv_post = WNConv1d(subbands, 1, 63, padding=31, bias=False)

    def forward(self, x: torch.Tensor, g: torch.Tensor, *, differentiable: bool):
        """``differentiable=True`` (training) runs the head as the plain
        :func:`quickvc_tpu_torch.dsp.istft.polar_inverse_stft`, which autograd
        differentiates, as the JAX training step runs its XLA head;
        ``False`` (inference) dispatches the head to kernel K3 on the card.

        The backbone computes in ``x``'s dtype; the head takes its spectra in
        float32 whatever that dtype (``quickvc_tpu/dsp/istft.py:114-115``), so
        both outputs are float32."""
        x = self.conv_pre(x) + self.cond(g)
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            blocks = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
            x = sum(rb(x) for rb in blocks) / self.num_kernels
        x = self.subband_conv_post(reflection_pad_left(leaky_relu(x, 0.01)))
        b, _, f = x.shape
        s, n_freq = self.subbands, self.n_fft // 2 + 1
        # band-major channels (B, s, 2*n_freq, F); bands fold into the batch.
        # The head reads these strided views in place: (B*s, F, n_freq).
        spec = x.view(b * s, 2 * n_freq, f).transpose(1, 2)
        head = polar_inverse_stft_plain if differentiable else polar_inverse_stft
        wave = head(spec[..., :n_freq].float(), spec[..., n_freq:].float(), self.n_fft, self.hop)
        y_mb = wave.view(b, s, -1)
        y_mb = F.conv_transpose1d(y_mb, self.updown_filter * s, stride=s)
        return self.multistream_conv_post(y_mb), y_mb
