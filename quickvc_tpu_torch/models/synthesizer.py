"""QuickVC generator ``SynthesizerTrn``, reference state_dict layout.

Port of ``quickvc_tpu/models/synthesizer.py`` (reference ``models.py:549-642``):
the training ``forward`` (posterior ``enc_q`` on the linear spectrogram,
forward flow, a random ``segment_size``-frame slice decoded with the
differentiable head) and ``infer`` (prior sample, reverse flow, decoder with
kernel K3). Tensors are channels-first: unit (B, 256, F), spec (B, 641, F),
mel (B, 80, F), as the reference's ``forward(c, spec, mel)`` takes them.

Both compute in their inputs' dtype (the training step and the live bench
pass bf16 at ``precision: "bf16"``, as the JAX step and bench cast): the
waves come back float32 (the decoder's head computes in float32), the
latents of ``forward`` in the inputs' dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from quickvc_tpu_torch.config import ModelConfig
from quickvc_tpu_torch.models.decoders import build_decoder
from quickvc_tpu_torch.models.encoders import SpeakerEncoder
from quickvc_tpu_torch.models.modules import CondNormalWN, ResidualCouplingBlock
from quickvc_tpu_torch.ops.slicing import rand_slice_segments, slice_segments


class SynthesizerTrn(nn.Module):
    def __init__(self, spec_channels: int, segment_size: int, model: ModelConfig):
        super().__init__()
        m = model
        self.model_cfg = m   # what a JAX parameter tree needs to map onto this module
        self.segment_size = segment_size
        self.enc_p = CondNormalWN(m.unit_channels, m.inter_channels, m.hidden_channels,
                                  5, 1, m.enc_wn_layers)
        self.enc_q = CondNormalWN(spec_channels, m.inter_channels, m.hidden_channels,
                                  5, 1, m.enc_wn_layers, gin_channels=m.gin_channels)
        self.flow = ResidualCouplingBlock(m.inter_channels, m.hidden_channels, 5, 1,
                                          m.flow_wn_layers, m.n_flows, m.gin_channels)
        self.enc_spk = SpeakerEncoder(model_hidden_size=m.gin_channels,
                                      model_embedding_size=m.gin_channels)
        self.dec = build_decoder(m)   # by m.decoder_kind: ms_istft, mb_istft or istft

    def forward(self, unit: torch.Tensor, spec: torch.Tensor, mel: torch.Tensor,
                generator: torch.Generator | None = None,
                eps_q: torch.Tensor | None = None,
                ids_slice: torch.Tensor | None = None):
        """Training forward. Returns (y_hat (B, 1, 320*seg), the decoder's
        second output (the MS streams before the learned post filter (B,
        subbands, 320*seg), the MB bands before the PQMF synthesis (B,
        subbands, 80*seg), None for the single-band decoder), ids_slice (B,),
        (z, z_p, m_p, logs_p, m_q, logs_q)).

        ``generator`` draws the posterior noise and the slice starts;
        ``eps_q`` (B, inter, F) and ``ids_slice`` (B,) replace those draws
        (tests inject the JAX package's). The prior's own sample is unused
        in training, so enc_p runs at noise 0.
        """
        m_p, logs_p = self.prior_stats(unit)
        o, o_mb, ids_slice, (z, z_p, m_q, logs_q) = self.forward_posterior(
            spec, mel, generator, eps_q, ids_slice)
        return o, o_mb, ids_slice, (z, z_p, m_p, logs_p, m_q, logs_q)

    def forward_posterior(self, spec: torch.Tensor, mel: torch.Tensor,
                          generator: torch.Generator | None = None,
                          eps_q: torch.Tensor | None = None,
                          ids_slice: torch.Tensor | None = None):
        """The training forward without the prior encoder
        (``quickvc_tpu/models/synthesizer.py:61-80``): everything the D phase
        takes (speaker embedding, posterior sample, flow, sliced decode).
        Returns (y_hat, the decoder's second output, ids_slice, (z, z_p, m_q,
        logs_q)); draws what :meth:`forward` draws, since ``enc_p`` draws
        nothing in training."""
        g = self.enc_spk(mel.transpose(1, 2))[:, :, None]
        z, m_q, logs_q = self.enc_q(spec, g, generator=generator, eps=eps_q)
        z_p = self.flow(z, g)
        if ids_slice is None:
            z_slice, ids_slice = rand_slice_segments(z, self.segment_size, generator)
        else:
            z_slice = slice_segments(z, ids_slice, self.segment_size)
        o, o_mb = self.dec(z_slice, g, differentiable=True)
        return o, o_mb, ids_slice, (z, z_p, m_q, logs_q)

    def prior_stats(self, unit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The prior encoder's (m_p, logs_p) of units (B, unit_channels, F)."""
        _, m_p, logs_p = self.enc_p(unit, noise_scale=0.0)
        return m_p, logs_p

    def infer(self, unit: torch.Tensor, g_vec: torch.Tensor, noise_scale: float = 1.0,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Units (B, unit_channels, F) + d-vectors (B, gin) -> wave (B, 1, 320*F)."""
        g = g_vec[:, :, None]
        z_p, _, _ = self.enc_p(unit, noise_scale=noise_scale, generator=generator)
        z = self.flow(z_p, g, reverse=True)
        return self.dec(z, g, differentiable=False)[0]

    def embed_speaker(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, F, 80) mel windows -> (B, gin) d-vectors."""
        return self.enc_spk(mel)
