"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """The device to run on; CUDA without a card raises instead of falling back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(name)!r} asked for, but no CUDA card is "
                           "available (pass --device cpu to run on the CPU)")
    return device
