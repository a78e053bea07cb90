"""Live voice-conversion sessions: push chunks as they arrive, get converted audio back.

Port of ``quickvc_tpu/infer/realtime.py``, with the same constructor
arguments, ``push``/``flush`` semantics and stream timeline. A session keeps
a sliding window of ``left`` frames of past context, ``chunk`` new frames
and ``right`` frames of lookahead on the device; each tick synthesizes the
whole window with ``SynthesizerTrn.infer`` (kernel K3 in the decoder head)
and keeps the ``chunk`` centre frames, so interior output matches
whole-utterance inference once the contexts cover the receptive field. The
batch dimension is N concurrent streams, one step per tick for all of them.

- :class:`RealtimeSession` takes 256-d HuBERT-soft unit frames;
- :class:`RealtimeWaveSession` takes raw 16 kHz samples and runs the port's
  ``HubertSoft.units`` on the wave window in the same tick (kernel K2 in
  every layer; windowed attention approximates HuBERT's global attention).

Stream timeline: the output lags the input by ``right`` frames. After k
pushes a session has returned ``k * chunk`` frames of audio covering input
frames ``[-right, k * chunk - right)`` (the first ``right`` frames are
lead-in synthesized from pre-session silence); :meth:`RealtimeSession.flush`
drains the last ``right``. Dropping the first ``right * hop`` output samples
aligns the audio 1:1 with the pushed input. Mouth-to-ear latency is the
chunk's duration plus the lookahead plus the step's compute time
(``python -m quickvc_tpu_torch.scripts.realtime_bench`` measures it).

Input and output are numpy arrays; the window, the nets and the step live on
``device`` (the card unless the caller passes ``"cpu"``), where the nets
must already be. ``dtype`` is the step's compute dtype: float32 by default;
``torch.bfloat16`` runs the step as the JAX live benchmark's bf16 steps do
(``scripts/realtime_bench.py:65-77``): units (from the window, or from
HuBERT-soft run on the bf16 wave window and cast to float32 first) and the
d-vectors cast to bf16 into ``infer`` at the session's noise; the audio
comes back float32. Every decoder runs; one that does not write
``hop_length`` samples a unit frame is refused
(:func:`quickvc_tpu_torch.infer.streaming.check_frame_rate`).
"""

from __future__ import annotations

import numpy as np
import torch

from quickvc_tpu_torch.infer.streaming import check_frame_rate
from quickvc_tpu_torch.utils.device import resolve_device


class RealtimeSession:
    """Stateful unit-domain streaming session (N concurrent streams).

    Push ``chunk`` unit frames per stream per call; receive ``chunk * hop``
    samples per stream, delayed by ``right`` frames. Call :meth:`flush` at
    the end of the stream to drain the tail.
    """

    def __init__(self, net, g_vec, *, chunk: int = 16, left: int = 48, right: int = 16,
                 hop_length: int = 320, unit_channels: int | None = None,
                 noise_scale: float = 0.0, seed: int = 0, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32):
        if chunk < 1 or left < 0 or right < 0:
            raise ValueError("chunk >= 1, contexts >= 0 required")
        check_frame_rate(net, hop_length)
        self.device = resolve_device(device)
        self.net = self._on_device(net)
        self.g_vec = torch.as_tensor(g_vec, dtype=torch.float32, device=self.device)
        self.batch = int(self.g_vec.shape[0])
        self.chunk, self.left, self.right = chunk, left, right
        self.hop = hop_length
        self.window = left + chunk + right
        self.noise_scale = float(noise_scale)
        self.dtype = dtype
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        dim = net.enc_p.pre.in_channels if unit_channels is None else unit_channels
        self._buf = torch.zeros((self.batch, self.window, dim), device=self.device)

    def _on_device(self, module):
        dev = next(module.parameters()).device
        if dev.type != self.device.type or self.device.index not in (None, dev.index):
            raise ValueError(f"session on {self.device}, but the model's weights are on {dev}")
        return module

    # -- the step -----------------------------------------------------------

    def step(self, window: torch.Tensor) -> torch.Tensor:
        """One tick on the device: a (N, window, C) unit window -> the
        (N, chunk * hop) centre of its synthesis."""
        with torch.inference_mode():
            wave = self.net.infer(window.transpose(1, 2).to(self.dtype),
                                  self.g_vec.to(self.dtype), self.noise_scale, self._gen)
        lo = self.left * self.hop
        return wave[:, 0, lo : lo + self.chunk * self.hop]

    # -- buffer plumbing (overridden by the wave-domain session) --------------

    def _block(self, units: np.ndarray | None) -> torch.Tensor:
        """One pushed chunk as a device tensor; None gives the zeros of a flush."""
        want = (self.batch, self.chunk, self._buf.shape[-1])
        if units is None:
            return torch.zeros(want, device=self.device)
        units = np.asarray(units, np.float32)
        if units.shape != want:
            raise ValueError(f"expected {want} units, got {units.shape}")
        return torch.from_numpy(units).to(self.device)

    def _roll_in(self, block: torch.Tensor) -> None:
        n = block.shape[1]
        self._buf = torch.cat([self._buf[:, n:], block], dim=1)

    # -- public API ----------------------------------------------------------

    def push(self, units: np.ndarray) -> np.ndarray:
        """Feed one chunk per stream; get (N, chunk * hop) converted samples."""
        self._roll_in(self._block(units))
        return self._run()

    def flush(self) -> np.ndarray:
        """Drain the last ``right`` input frames: returns (N, right * hop)."""
        out = []
        remaining = self.right
        while remaining > 0:
            self._roll_in(self._block(None))   # zero-padded future
            out.append(self._run()[:, : min(remaining, self.chunk) * self.hop])
            remaining -= self.chunk
        return (np.concatenate(out, axis=1) if out
                else np.zeros((self.batch, 0), np.float32))

    def _run(self) -> np.ndarray:
        return self.step(self._buf).float().cpu().numpy()


class RealtimeWaveSession(RealtimeSession):
    """Wave-in / wave-out live conversion: HuBERT-soft runs in the step.

    Push ``chunk * hop`` raw 16 kHz samples per stream per call. Each tick
    encodes the whole (left + chunk + right)-frame wave window to units with
    ``hubert`` (a :class:`~quickvc_tpu_torch.models.hubert.HubertSoft`) and
    synthesizes it.
    """

    def __init__(self, net, g_vec, hubert, **kw):
        super().__init__(net, g_vec, **kw)
        self.hubert = self._on_device(hubert)
        self._buf = torch.zeros((self.batch, self.window * self.hop), device=self.device)

    def step(self, window: torch.Tensor) -> torch.Tensor:
        """One tick: a (N, window * hop) wave window -> (N, chunk * hop) samples."""
        with torch.inference_mode():
            units = self.hubert.units(window.to(self.dtype)).float()
        return super().step(units)

    def _block(self, wave: np.ndarray | None) -> torch.Tensor:
        want = (self.batch, self.chunk * self.hop)
        if wave is None:
            return torch.zeros(want, device=self.device)
        wave = np.asarray(wave, np.float32)
        if wave.shape != want:
            raise ValueError(f"expected {want} samples, got {wave.shape}")
        return torch.from_numpy(wave).to(self.device)
