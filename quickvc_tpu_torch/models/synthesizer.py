"""QuickVC generator ``SynthesizerTrn``: inference path, reference state_dict layout.

Port of ``quickvc_tpu/models/synthesizer.py`` (reference ``models.py:549-642``).
``enc_q`` is built (the training posterior) so that a reference ``G_*.pth``
loads with ``strict=True``; ``infer`` does not run it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from quickvc_tpu_torch.config import ModelConfig
from quickvc_tpu_torch.models.decoders import MultistreamISTFTGenerator
from quickvc_tpu_torch.models.encoders import SpeakerEncoder
from quickvc_tpu_torch.models.modules import CondNormalWN, ResidualCouplingBlock


class SynthesizerTrn(nn.Module):
    def __init__(self, spec_channels: int, segment_size: int, model: ModelConfig):
        super().__init__()
        m = model
        if m.decoder_kind != "ms_istft":
            raise NotImplementedError(
                f"decoder {m.decoder_kind!r}: the port has the multistream "
                "iSTFT decoder only")
        self.segment_size = segment_size
        self.enc_p = CondNormalWN(m.unit_channels, m.inter_channels, m.hidden_channels,
                                  5, 1, m.enc_wn_layers)
        self.enc_q = CondNormalWN(spec_channels, m.inter_channels, m.hidden_channels,
                                  5, 1, m.enc_wn_layers, gin_channels=m.gin_channels)
        self.flow = ResidualCouplingBlock(m.inter_channels, m.hidden_channels, 5, 1,
                                          m.flow_wn_layers, m.n_flows, m.gin_channels)
        self.enc_spk = SpeakerEncoder(model_hidden_size=m.gin_channels,
                                      model_embedding_size=m.gin_channels)
        self.dec = MultistreamISTFTGenerator(
            m.inter_channels, m.resblock_kernel_sizes, m.resblock_dilation_sizes,
            m.upsample_rates, m.upsample_initial_channel, m.upsample_kernel_sizes,
            m.gen_istft_n_fft, m.gen_istft_hop_size, m.subbands, m.gin_channels)

    def infer(self, unit: torch.Tensor, g_vec: torch.Tensor, noise_scale: float = 1.0,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Units (B, unit_channels, F) + d-vectors (B, gin) -> wave (B, 1, 320*F)."""
        g = g_vec[:, :, None]
        z_p, _, _ = self.enc_p(unit, noise_scale=noise_scale, generator=generator)
        z = self.flow(z_p, g, reverse=True)
        return self.dec(z, g)[0]

    def embed_speaker(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, F, 80) mel windows -> (B, gin) d-vectors."""
        return self.enc_spk(mel)
