"""Speaker encoder: 3-layer LSTM d-vector, with sliding-window averaging.

Port of ``quickvc_tpu/models/encoders.py`` in the reference's own layout
(``models.py:507-546``): ``nn.LSTM(80 -> 256, 3 layers, batch_first)``
(gate order i, f, g, o), Linear, ReLU, L2 normalization.

A float32 mel runs ``nn.LSTM`` (cuDNN on the card). ``nn.LSTM`` takes no
bf16 input with float32 weights, so a mel in another dtype (bf16 in
training at ``precision: "bf16"``) takes copies of the weights in that
dtype, with the two biases of a layer summed in float32 and then cast, as
the JAX package sums them (``quickvc_tpu/models/encoders.py:74-91``):
- on the card, cuDNN's LSTM runs on them (its recurrence keeps its own
  internal precision);
- on the CPU, :meth:`SpeakerEncoder._recurrence` runs the JAX recurrence
  itself, step by step, ``h`` and ``c`` carried in the input's dtype.
``chip_smoke.py`` holds the first against the second.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn as nn

from quickvc_tpu_torch.models.layers import Linear


class SpeakerEncoder(nn.Module):
    """Mel (B, T, 80) -> L2-normalized d-vector (B, E)."""

    def __init__(self, mel_n_channels: int = 80, model_num_layers: int = 3,
                 model_hidden_size: int = 256, model_embedding_size: int = 256):
        super().__init__()
        self.lstm = nn.LSTM(mel_n_channels, model_hidden_size, model_num_layers,
                            batch_first=True)
        self.linear = Linear(model_hidden_size, model_embedding_size)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        if mels.dtype == torch.float32:
            h = self.lstm(mels)[1][0][-1]
        elif mels.is_cuda:
            h = self._cudnn(mels)
        else:
            h = self._recurrence(mels)
        e = torch.relu(self.linear(h))
        return e / torch.norm(e, dim=1, keepdim=True)

    def _layer_weights(self, layer: int, dt: torch.dtype):
        """Layer ``layer``'s (w_ih, w_hh, b_ih + b_hh) in ``dt``, the biases
        summed in float32."""
        w_ih, w_hh, b_ih, b_hh = (getattr(self.lstm, f"{name}_l{layer}") for name in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        return w_ih.to(dt), w_hh.to(dt), (b_ih + b_hh).to(dt)

    def _cudnn(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's final ``h`` (B, H) from cuDNN's LSTM in ``x``'s dtype."""
        lstm = self.lstm
        weights = []
        for layer in range(lstm.num_layers):
            w_ih, w_hh, b = self._layer_weights(layer, x.dtype)
            weights += [w_ih, w_hh, b, torch.zeros_like(b)]
        h0 = x.new_zeros(lstm.num_layers, x.shape[0], lstm.hidden_size)
        with warnings.catch_warnings():   # the copies are not one flat buffer: cuDNN packs them
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            _, h, _ = torch.lstm(x, (h0, h0), weights, True, lstm.num_layers, 0.0,
                                 self.training, False, True)
        return h[-1]

    def _recurrence(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's final ``h`` (B, H), computed in ``x``'s dtype."""
        lstm, dt = self.lstm, x.dtype
        for layer in range(lstm.num_layers):
            w_ih, w, b = self._layer_weights(layer, dt)
            xp = x @ w_ih.T + b                        # (B, T, 4H), every step
            w = w.T
            h = c = x.new_zeros(x.shape[0], lstm.hidden_size)
            hs = []
            for t in range(x.shape[1]):
                i, f, g, o = (xp[:, t] + h @ w).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            x = torch.stack(hs, dim=1)
        return h


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
