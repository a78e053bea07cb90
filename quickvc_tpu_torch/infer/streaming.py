"""Streaming-chunk inference: synthesis of long utterances in fixed-size windows.

Port of ``quickvc_tpu/infer/streaming.py``. The full inference path (prior
encoder -> reverse flow -> decoder, kernel K3 in its head) runs over windows
of ``chunk`` unit frames with ``context`` frames of context on each side;
the context margins are synthesized and dropped, so the chunk interiors
match whole-utterance inference once the context covers the model's
receptive field (~75 frames at the full width of ``configs/quickvc.json``:
enc_p's 16-layer WaveNet +-32, the 4 x 4 flow couplings +-32, the decoder
~+-10). Memory stays O(chunk) whatever the utterance length. Where the JAX
package scans one compiled program over the windows, this is a Python loop:
one ``infer`` (one K3 launch) per window for the whole batch.

Every decoder runs here (multistream, multiband, single-band), as in the
JAX package; the windows are cut at ``hop_length`` output samples a unit
frame, so a model whose decoder writes another number a frame (the
single-band decoder at ``upsample_rates`` [5, 4] writes 80) is refused by
:func:`check_frame_rate`, where the JAX package would cut misaligned windows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def check_frame_rate(net, hop_length: int) -> None:
    """Raise ValueError unless ``net``'s decoder writes ``hop_length`` samples a unit frame."""
    got = net.dec.samples_per_frame
    if got != hop_length:
        raise ValueError(f"the decoder writes {got} samples a unit frame, not hop_length "
                         f"{hop_length}: windows cut at the hop would be misaligned")


def streaming_infer(net, unit: torch.Tensor, g_vec: torch.Tensor, hop_length: int = 320,
                    chunk: int = 96, context: int = 48, noise_scale: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Units (B, C, F) + d-vectors (B, gin) -> wave (B, F * hop_length).

    ``net`` is a :class:`~quickvc_tpu_torch.models.synthesizer.SynthesizerTrn`.
    The units are zero-padded by ``context`` frames on each side and up to
    whole chunks at the end. With ``noise_scale`` != 0 each window draws its
    prior noise from ``generator`` in turn (not the JAX package's stream).
    """
    if chunk < 1 or context < 0:
        raise ValueError("chunk >= 1 and context >= 0 required")
    check_frame_rate(net, hop_length)
    b, _, f = unit.shape
    n_chunks = -(-f // chunk)
    # layout: [context | units, zero-padded to whole chunks | context]
    unit_p = F.pad(unit, (context, n_chunks * chunk - f + context))
    window = chunk + 2 * context
    start, stop = context * hop_length, (context + chunk) * hop_length
    out = []
    for i in range(n_chunks):
        win = unit_p[:, :, i * chunk : i * chunk + window]
        wave = net.infer(win, g_vec, noise_scale, generator)   # (B, 1, window * hop)
        out.append(wave[:, 0, start:stop])
    return torch.cat(out, dim=1)[:, : f * hop_length]
