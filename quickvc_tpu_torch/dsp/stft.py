"""Forward STFT featurization, plain PyTorch (the oracles of kernels K1 and K4).

Same contract as ``quickvc_tpu/dsp/stft.py`` and reference
``mel_processing.py:15-98``: reflect-pad ``(n_fft - hop)/2`` both sides,
periodic Hann window, ``center=False``, magnitude ``sqrt(re^2 + im^2 + 1e-6)``,
Slaney mel matmul, ``log(clamp(x, 1e-5))``.

Layout: waveforms ``(..., T)``; spectrograms time-major ``(..., Frame, Freq)``
as in the JAX package, so the two compare like with like.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, identical to ``torch.hann_window(n)``."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(dtype)


def padded_window(n_fft: int, win_size: int) -> np.ndarray:
    """Hann(win_size) centred in n_fft samples, as torch.stft pads it."""
    w = np.zeros(n_fft, np.float32)
    off = (n_fft - win_size) // 2
    w[off : off + win_size] = hann_window(win_size)
    return w


def reflect_pad(y: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``F.pad(y, (left, right), mode="reflect")`` on the last axis, built from
    slices, ``flip`` and ``cat``: the same values and, since each padded
    sample repeats one other, the same gradients (a sum of two), but a
    backward that has a deterministic version on the card, which
    ``ReflectionPad1d``'s has not (``torch.use_deterministic_algorithms``
    refuses it; the trainer's ``--deterministic``)."""
    parts = [y]
    if left:
        parts.insert(0, y[..., 1 : left + 1].flip(-1))
    if right:
        parts.append(y[..., -right - 1 : -1].flip(-1))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else y


def wave_to_spec(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int) -> torch.Tensor:
    """Linear spectrogram: (..., T) -> (..., T//hop, n_fft//2+1), float32."""
    pad = (n_fft - hop_size) // 2
    lead = y.shape[:-1]
    y = reflect_pad(y.float().reshape(-1, y.shape[-1]), pad, pad)
    frames = y.unfold(-1, n_fft, hop_size)                # (N, Frame, n_fft)
    w = torch.as_tensor(padded_window(n_fft, win_size), device=y.device)
    z = torch.fft.rfft(frames * w, dim=-1)
    spec = torch.sqrt(z.real * z.real + z.imag * z.imag + 1e-6)
    return spec.reshape(*lead, *spec.shape[-2:])


def wave_to_spec_halo(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int) -> torch.Tensor:
    """:func:`wave_to_spec` of a wave that already carries the ``(n_fft-hop)/2``
    halo on both ends, so nothing is padded: (B, T + 2*pad) -> (B, T//hop, Freq).

    The compact-transfer training batch (``train.transfer='compact'``) ships
    such a crop; the halo gives each frame the samples the full path's
    reflect-padded utterance would have given it.
    """
    frames = y.float().unfold(-1, n_fft, hop_size)         # (B, Frame, n_fft)
    w = torch.as_tensor(padded_window(n_fft, win_size), device=y.device)
    z = torch.fft.rfft(frames * w, dim=-1)
    return torch.sqrt(z.real * z.real + z.imag * z.imag + 1e-6)


def magnitude_stft(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int) -> torch.Tensor:
    """Centred magnitude STFT of the sub-band loss: (..., T) -> (..., Frame, Freq).

    ``quickvc_tpu/dsp/stft.py:magnitude_stft`` (torchaudio's ``Spectrogram``
    with ``power=1``): reflect-pad ``n_fft // 2`` on both sides, Hann(win)
    zero-padded to ``n_fft`` at offset ``(n_fft - win) // 2``, plain ``|z|``.
    Odd ``n_fft`` (683, 171 in the shipped resolutions) frame and transform
    like the JAX version. Differentiable; float32 (float64 stays float64, the
    tests' oracle).
    """
    pad = n_fft // 2
    lead = y.shape[:-1]
    y = y if y.dtype == torch.float64 else y.float()
    y = reflect_pad(y.reshape(-1, y.shape[-1]), pad, pad)
    frames = y.unfold(-1, n_fft, hop_size)                # (N, Frame, n_fft)
    w = torch.as_tensor(padded_window(n_fft, win_size), device=y.device, dtype=y.dtype)
    mag = torch.fft.rfft(frames * w, dim=-1).abs()
    return mag.reshape(*lead, *mag.shape[-2:])


def spec_to_mel(spec: torch.Tensor, mel_basis: torch.Tensor) -> torch.Tensor:
    """(..., Frame, Freq) x (Mel, Freq) -> log-mel (..., Frame, Mel)."""
    return torch.log(torch.clamp(spec @ mel_basis.T, min=1e-5))


def wave_to_mel(y: torch.Tensor, mel_basis: torch.Tensor, n_fft: int,
                hop_size: int, win_size: int) -> torch.Tensor:
    """(..., T) -> (..., T//hop, Mel): reference ``wave_to_mel``."""
    return spec_to_mel(wave_to_spec(y, n_fft, hop_size, win_size), mel_basis)
