"""Training checkpoints in the reference's format (reference ``utils.py:147-193``).

``G_{step}.pth`` and ``D_{step}.pth`` each hold ``{"model": state_dict,
"iteration": epoch, "optimizer": AdamW state_dict, "learning_rate": lr}``;
``step`` in the name is the number of training steps taken. A generator
checkpoint loads into the converter with ``strict=True``.
"""

from __future__ import annotations

import os
import re

import torch


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    learning_rate: float, iteration: int) -> None:
    tmp = path + ".tmp"
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "iteration": int(iteration), "optimizer": optimizer.state_dict(),
                "learning_rate": float(learning_rate)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> int:
    """Copy a checkpoint's weights (strictly) and optimizer state into live
    objects on any device; returns its ``iteration``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["iteration"])


def latest_step(model_dir: str) -> int | None:
    """The largest ``step`` for which both ``G_{step}.pth`` and ``D_{step}.pth`` exist."""
    if not os.path.isdir(model_dir):
        return None
    steps = {}
    for name in os.listdir(model_dir):
        m = re.fullmatch(r"([GD])_(\d+)\.pth", name)
        if m:
            steps.setdefault(int(m.group(2)), set()).add(m.group(1))
    pairs = [s for s, kinds in steps.items() if kinds == {"G", "D"}]
    return max(pairs) if pairs else None
