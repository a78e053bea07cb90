"""Random segment slicing (training-time crops), plain PyTorch.

Port of ``quickvc_tpu/ops/slicing.py`` (reference ``commons.py:20-56``) on
the port's channels-first layout: series ``(B, C, T)``, sliced on the last
axis with one gather, so the slice is differentiable and needs no host sync.
"""

from __future__ import annotations

import torch


def slice_segments(series: torch.Tensor, start_indices: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """Per-item slice: (B, C, T), (B,) -> (B, C, segment_size)."""
    idx = start_indices.to(series.device, torch.long)[:, None] + torch.arange(
        segment_size, device=series.device)
    idx = idx[:, None, :].expand(series.shape[0], series.shape[1], segment_size)
    return series.gather(-1, idx)


def rand_slice_segments(series: torch.Tensor, segment_size: int,
                        generator: torch.Generator | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform-random segment per item; returns (segments, start_indices).

    Starts are ``floor(u * (T - segment_size + 1))`` with ``u ~ U[0, 1)`` in
    float32, the reference's +1 convention (commons.py:50-51). ``u`` is drawn
    from ``generator`` on its own device.
    """
    b, _, t = series.shape
    gen_device = generator.device if generator is not None else series.device
    u = torch.rand(b, generator=generator, device=gen_device)
    starts = (u * float(t - segment_size + 1)).to(torch.long).to(series.device)
    return slice_segments(series, starts, segment_size), starts
