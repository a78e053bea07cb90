"""Pseudo-QMF filterbank of the multiband decoder, plain PyTorch.

The port's own copy of ``quickvc_tpu/dsp/pqmf.py`` (reference ``pqmf.py``):
a 62-tap Kaiser prototype (cutoff 0.15, beta 9) designed in numpy, cosine
modulated into ``subbands`` analysis and synthesis filters. ``analysis`` is
a strided convolution; ``synthesis`` zero-stuffs each band ``subbands``
times (scaled by ``subbands``) and convolves. The JAX package computes
these outside any Pallas kernel, so they are PyTorch convolutions here.

Layout: channels-first, waves (B, 1, T) and bands (B, subbands, T // subbands).
The filters are constants built per call from a cached numpy design, so the
decoder that uses them carries no buffer in its state dict (the reference's
``Multiband_iSTFT_Generator`` builds its PQMF in ``forward``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

TAPS, CUTOFF_RATIO, BETA = 62, 0.15, 9.0


def design_prototype_filter(taps: int = TAPS, cutoff_ratio: float = CUTOFF_RATIO,
                            beta: float = BETA) -> np.ndarray:
    """Kaiser-window lowpass prototype, length ``taps + 1``."""
    if taps % 2 or not 0.0 < cutoff_ratio < 1.0:
        raise ValueError(f"taps {taps} must be even and cutoff {cutoff_ratio} in (0, 1)")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # the sinc's limit at n = 0
    return h_i * np.kaiser(taps + 1, beta)


@functools.lru_cache(maxsize=None)
def modulated_filters(subbands: int, taps: int = TAPS, cutoff_ratio: float = CUTOFF_RATIO,
                      beta: float = BETA) -> tuple[np.ndarray, np.ndarray]:
    """Cosine-modulated analysis and synthesis banks, each (subbands, taps + 1) float32."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    t = np.arange(taps + 1) - (taps - 1) / 2.0
    k = np.arange(subbands)[:, None]
    arg = (2 * k + 1) * (np.pi / (2 * subbands)) * t[None, :]
    sign = ((-1.0) ** k) * np.pi / 4.0
    h_analysis = 2.0 * h_proto[None, :] * np.cos(arg + sign)
    h_synthesis = 2.0 * h_proto[None, :] * np.cos(arg - sign)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


def analysis(x: torch.Tensor, subbands: int) -> torch.Tensor:
    """(B, 1, T) -> (B, subbands, T // subbands), in float32."""
    h_a, _ = modulated_filters(subbands)
    w = torch.as_tensor(h_a, device=x.device)[:, None, :]        # (s, 1, taps + 1)
    return F.conv1d(x.float(), w, stride=subbands, padding=TAPS // 2)


def synthesis(x: torch.Tensor) -> torch.Tensor:
    """(B, subbands, T') -> (B, 1, subbands * T'), in float32."""
    b, s, t = x.shape
    _, h_s = modulated_filters(s)
    w = torch.as_tensor(h_s, device=x.device)[None]               # (1, s, taps + 1)
    # zero-stuffing: band sample t lands at s * t, the s - 1 after it are zero
    up = F.pad(x.float()[..., None] * float(s), (0, s - 1)).reshape(b, s, s * t)
    return F.conv1d(up, w, padding=TAPS // 2)
