"""Speaker encoder: 3-layer LSTM d-vector, with sliding-window averaging.

Port of ``quickvc_tpu/models/encoders.py`` in the reference's own layout
(``models.py:507-546``): ``nn.LSTM(80 -> 256, 3 layers, batch_first)``
(gate order i, f, g, o), Linear, ReLU, L2 normalization.

A float32 mel runs ``nn.LSTM`` (cuDNN on the card), within float32
tolerance of the JAX LSTM. A mel in another dtype (bf16 in training at
``precision: "bf16"``) runs the JAX recurrence itself,
:meth:`SpeakerEncoder._recurrence`, on copies of the weights in that dtype
with the two biases of a layer summed in float32 and then cast, as the JAX
package sums them (``quickvc_tpu/models/encoders.py:74-91``): layer 0's
input projection one ``torch.matmul``, the stack ``ops.lstm_recurrence.
LSTMStack`` (the plain per-layer versions chained on the CPU; on the card
one launch of the forward kernel for every layer, the JAX package's
wavefront schedule, with each deeper layer's projection per step, and one
backward launch a layer), ``h`` and ``c`` carried in bf16 and every op of
the cell rounded as JAX rounds.
cuDNN's bf16 LSTM on the same copies, the card's path before the kernels,
is no path of the port: ``scripts/bf16_step_gate.py --card-lstm cudnn``
runs it for attribution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from quickvc_tpu_torch.models.layers import Linear
from quickvc_tpu_torch.ops.lstm_recurrence import lstm_stack


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

    def _recurrence(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's final ``h`` (B, H), computed in ``x``'s dtype:
        layer 0's input projection of every step, then the stack, each
        deeper layer projecting the layer below's h as it goes."""
        w_ih, w_hh, b = zip(*(self._layer_weights(layer, x.dtype)
                              for layer in range(self.lstm.num_layers)))
        return lstm_stack(x @ w_ih[0].T + b[0], w_ih[1:], b[1:], w_hh)[:, -1]


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
