"""Speaker encoder: 3-layer LSTM d-vector, with sliding-window averaging.

Port of ``quickvc_tpu/models/encoders.py`` in the reference's own layout
(``models.py:507-546``): ``nn.LSTM(80 -> 256, 3 layers, batch_first)``
(gate order i, f, g, o), Linear, ReLU, L2 normalization.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class SpeakerEncoder(nn.Module):
    """Mel (B, T, 80) -> L2-normalized d-vector (B, E)."""

    def __init__(self, mel_n_channels: int = 80, model_num_layers: int = 3,
                 model_hidden_size: int = 256, model_embedding_size: int = 256):
        super().__init__()
        self.lstm = nn.LSTM(mel_n_channels, model_hidden_size, model_num_layers,
                            batch_first=True)
        self.linear = nn.Linear(model_hidden_size, model_embedding_size)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        _, (hidden, _) = self.lstm(mels)
        e = torch.relu(self.linear(hidden[-1]))
        return e / torch.norm(e, dim=1, keepdim=True)


def partial_slices(total_frames: int, partial_frames: int = 128,
                   partial_hop: int = 64) -> list[int]:
    """Sliding-window start indices (reference models.py:520-526)."""
    return list(range(0, total_frames - partial_frames, partial_hop))


def embed_utterance(encoder: SpeakerEncoder, mel: torch.Tensor,
                    partial_frames: int = 128, partial_hop: int = 64) -> torch.Tensor:
    """Mean d-vector over 128-frame windows at hop 64 (reference models.py:528-546).

    mel: (1, T, 80) -> (1, E). The last ``partial_frames`` frames always form
    a window; an utterance of at most ``partial_frames`` is one window.
    """
    t = mel.shape[1]
    last = mel[:, -partial_frames:]
    if t <= partial_frames:
        return encoder(last)
    windows = [mel[0, s : s + partial_frames]
               for s in partial_slices(t, partial_frames, partial_hop)] + [last[0]]
    return encoder(torch.stack(windows)).mean(dim=0, keepdim=True)
