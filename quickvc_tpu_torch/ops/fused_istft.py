"""Kernel K3: polar decode + inverse STFT head (``csrc/fused_istft.cu``) and its dispatch.

Replaces the TPU kernel ``quickvc_tpu/ops/fused_istft.py:polar_inverse_stft_pallas``.
A CPU tensor takes the plain version,
:func:`quickvc_tpu_torch.dsp.istft.polar_inverse_stft`; a CUDA tensor
launches the kernel or raises. The kernel takes the (n_fft, hop) pairs the
TPU kernel asserts, with n_fft up to :data:`MAX_N_FFT`: :func:`istft_route`
says which body runs, the one compiled for the decoder's 16 / 4, on the grid
:func:`istft_plan` gives and the basis and envelope :func:`compiled_tables`
builds, or the one that reads :func:`istft_table`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from quickvc_tpu_torch.dsp.istft import _inverse_dft_matrices, _ola_envelope
from quickvc_tpu_torch.dsp.istft import polar_inverse_stft as polar_inverse_stft_plain
from quickvc_tpu_torch.dsp.stft import hann_window
from quickvc_tpu_torch.ops._cuda import (AT_EDGE, KernelStats, check, device_sms, library,
                                         on_tensor_device, refuse_grad, require_cuda, stream_ptr)

STATS = KernelStats("polar_inverse_stft")
# the (n_fft, hop) with a body of its own (configs/quickvc.json decoder)
COMPILED = (16, 4)
MAX_N_FFT = 2048
MAX_FRAMES_PER_HOP = 128   # n_fft / hop, the TPU kernel's bound (its halo of 128 lanes)
# the compiled body's grid (csrc/fused_istft.cu): chunks a block stores per
# step (one a thread), blocks resident on an SM (its __launch_bounds__), and
# the fewest chunks a block walks when one step a block covers the batch, so
# that a small batch spreads over the SMs
TILE = 128
BLOCKS_PER_SM = 6
MIN_SPAN = 64
_R = COMPILED[0] // COMPILED[1]   # frames overlapping one output chunk
EDGE = _R // 2 - 1                # chunks at each end of a row that miss a frame


def istft_route(n_fft: int, hop: int) -> str:
    """K3's body for (n_fft, hop): ``"compiled"`` for :data:`COMPILED`,
    ``"table"`` for any other pair with hop | n_fft, n_fft / hop even and at
    most 128 (the asserts of ``quickvc_tpu/ops/fused_istft.py``) and n_fft up
    to :data:`MAX_N_FFT`; ``ValueError`` for the rest."""
    r = n_fft // hop if hop > 0 else 0
    if hop <= 0 or n_fft % hop or r % 2 or not 0 < r <= MAX_FRAMES_PER_HOP \
            or n_fft > MAX_N_FFT:
        raise ValueError(f"polar_inverse_stft: the kernel takes hop | n_fft with n_fft/hop "
                         f"even and at most {MAX_FRAMES_PER_HOP}, n_fft <= {MAX_N_FFT}; "
                         f"got n_fft={n_fft} hop={hop}")
    return "compiled" if (n_fft, hop) == COMPILED else "table"


class IstftPlan(NamedTuple):
    """The compiled body's grid: ``slots`` chunk slots (rows laid end to end,
    F - 1 output chunks and R - 1 dead slots a row, less the last row's dead
    ones), split evenly over ``blocks`` persistent blocks, each walking its
    span in steps of ``tile`` chunks, the first step R - 1 fewer."""
    slots: int
    blocks: int
    tile: int

    def span(self, block: int) -> tuple[int, int]:
        """The chunk slots [begin, end) that ``block`` walks, as the kernel
        computes them: ``slots // blocks`` each, one more for the first
        ``slots % blocks``."""
        span, longer = divmod(self.slots, self.blocks)
        begin = block * span + min(block, longer)
        return begin, begin + span + (block < longer)

    def steps(self, block: int) -> list[tuple[int, int]]:
        """(first chunk slot, chunks) of each of ``block``'s steps, in order:
        the first decodes all the frames it reads, the others carry the R - 1
        frames they share with the step before."""
        begin, end = self.span(block)
        out, lead = [], 0
        while begin < end:
            n = min(self.tile - (_R - 1) + lead, end - begin)
            out.append((begin, n))
            begin, lead = begin + n, _R - 1
        return out


def istft_plan(rows: int, n_frames: int, sm_count: int = 132) -> IstftPlan:
    """The grid of the compiled body for ``rows`` rows of ``n_frames`` frames
    on ``sm_count`` SMs, at most :data:`BLOCKS_PER_SM` blocks an SM, all
    resident. Where one step a block covers the batch, blocks of
    :data:`MIN_SPAN` chunks (a live tick of one stream, (4, 1361): 86
    blocks on 86 SMs). Otherwise the fewest steps a block that the
    resident blocks allow, and then as few blocks as walk them in full
    steps: a step's time hardly depends on how many of its chunks are live,
    so a last step of a few chunks costs a whole one. At the conversion's
    (32, 5001): 633 blocks of ~253 chunks, two steps each (125 + 128), so
    each block decodes one step while the next one's spectra load."""
    first = TILE - (_R - 1)
    slots = rows * (n_frames + 2 * EDGE) - (_R - 1)
    most = sm_count * BLOCKS_PER_SM
    if slots <= most * first:
        return IstftPlan(slots, max(1, min(most, -(-slots // MIN_SPAN))), TILE)
    steps = 1 + -(-(-(-slots // most) - first) // TILE)
    return IstftPlan(slots, -(-slots // (first + (steps - 1) * TILE)), TILE)


def envelope_table(n_frames: int) -> np.ndarray:
    """(2 EDGE + 1, hop) float32: the inverse squared-window envelope of the
    compiled size, ``dsp.istft._ola_envelope`` trimmed, as its EDGE first
    output chunks, one chunk of its hop-periodic interior and its EDGE last
    chunks. Every other chunk equals the interior one, and past R frames
    none of the three depends on ``n_frames`` (each sums the same squared
    window values in the same order); for fewer chunks than 2 EDGE + 1 the
    first and last overlap, and the interior one is not read."""
    n_fft, hop = COMPILED
    half = n_fft // 2

    def trimmed(f: int) -> np.ndarray:
        return _ola_envelope(f, n_fft, hop)[half:-half].reshape(f - 1, hop)

    env = trimmed(min(n_frames, _R))
    return np.concatenate([env[:EDGE], trimmed(_R)[EDGE:EDGE + 1], env[len(env) - EDGE:]])


@functools.lru_cache(maxsize=None)
def compiled_tables(n_frames: int) -> np.ndarray:
    """What the compiled body reads besides the spectra, float32, in the
    layout of ``csrc/fused_istft.cu:Tables<16, 4>``: the windowed
    inverse-DFT basis of ``dsp.istft._inverse_dft_matrices`` where its
    symmetry does not repeat it (the periodic Hann window is symmetric), its
    re part at n <= N/2 and the negative of its im part at 0 < k, n < N/2;
    then :func:`envelope_table`. The same array for every ``n_frames`` from
    R on; the wrapper asks with ``min(F, R)``."""
    half = COMPILED[0] // 2
    basis_re, basis_im = _inverse_dft_matrices(COMPILED[0])
    return np.ascontiguousarray(np.concatenate(
        [basis_re[:, :half + 1].ravel(), -basis_im[1:half, 1:half].ravel(),
         envelope_table(n_frames).ravel()]), np.float32)


@functools.lru_cache(maxsize=1024)
def _compiled_launch(rows: int, n_frames: int, device_index: int) -> tuple[int, int]:
    """(host address of :func:`compiled_tables`, which its cache keeps
    alive; blocks) of a compiled-body launch: what the wrapper hands the
    kernel besides the tensors, the same for every call of one shape on one
    card."""
    return (compiled_tables(min(n_frames, _R)).ctypes.data,
            istft_plan(rows, n_frames, device_sms(device_index)).blocks)


@functools.lru_cache(maxsize=None)
def istft_table(n_fft: int) -> np.ndarray:
    """What the run-time body reads besides the spectra, float32, each value
    rounded once from float64: cos and sin(2 pi j / n_fft), j < n_fft; the
    periodic Hann window over n_fft; its square."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    w = hann_window(n_fft, np.float64)
    return np.concatenate([np.cos(ang), np.sin(ang), w / n_fft, w * w]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_table(device: torch.device, n_fft: int) -> torch.Tensor:
    return torch.as_tensor(istft_table(n_fft), device=device)


def _spectra(log_mag: torch.Tensor, phase: torch.Tensor, n_fft: int) -> tuple[int, int]:
    """(rows, F) of two (rows, F >= 2, n_fft/2+1) spectra, or ``ValueError``."""
    shape = log_mag.shape
    if len(shape) != 3 or shape != phase.shape or shape[2] != n_fft // 2 + 1 or shape[1] < 2:
        raise ValueError(f"polar_inverse_stft: need two (rows, F>=2, {n_fft // 2 + 1}) "
                         f"spectra, got {tuple(shape)} and {tuple(phase.shape)}")
    return shape[0], shape[1]


@on_tensor_device
def polar_inverse_stft_kernel(log_mag: torch.Tensor, phase: torch.Tensor,
                              n_fft: int, hop: int) -> torch.Tensor:
    """Launch K3: (rows, F, n_fft//2+1) x2 float32 CUDA, any strides ->
    (rows, hop*(F-1)); (n_fft, hop) as :func:`istft_route` takes them."""
    require_cuda("polar_inverse_stft", log_mag, phase, why=AT_EDGE)
    compiled = (n_fft, hop) == COMPILED
    if not compiled:
        istft_route(n_fft, hop)
    rows, f = _spectra(log_mag, phase, n_fft)
    dev = log_mag.device
    out = torch.empty((rows, hop * (f - 1)), device=dev, dtype=torch.float32)
    if compiled:
        table = None
        host, blocks = _compiled_launch(rows, f, dev.index)
    else:
        table, host, blocks = _device_table(dev, n_fft).data_ptr(), None, 0
    check(library().qvc_polar_istft(
        log_mag.data_ptr(), phase.data_ptr(), *log_mag.stride(), *phase.stride(),
        out.data_ptr(), rows, f, n_fft, hop, table, host, blocks, stream_ptr(log_mag)),
        "polar_inverse_stft kernel")
    STATS.count()
    return out


def polar_inverse_stft(log_mag: torch.Tensor, phase: torch.Tensor,
                       n_fft: int, hop: int) -> torch.Tensor:
    """(rows, F, n_fft//2+1) x2 -> (rows, hop*(F-1)): plain on CPU, K3 on CUDA.

    K3 has no backward, so inputs that require grad are refused on both
    devices; training differentiates through the plain version directly.
    """
    refuse_grad("polar_inverse_stft", log_mag, phase)
    if log_mag.device.type == "cpu":
        return polar_inverse_stft_plain(log_mag, phase, n_fft, hop)
    return polar_inverse_stft_kernel(log_mag, phase, n_fft, hop)
