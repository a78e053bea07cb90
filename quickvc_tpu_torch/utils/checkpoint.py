"""Training checkpoints in the reference's format (reference ``utils.py:147-193``).

``G_{step}.pth`` and ``D_{step}.pth`` each hold ``{"model": state_dict,
"iteration": epoch, "optimizer": AdamW state_dict, "learning_rate": lr}``;
``step`` in the name is the number of training steps taken. A generator
checkpoint loads into the converter with ``strict=True``, and the optimizer
entry into a plain ``AdamW`` over the network's parameters: the trainer
hands it over in that layout whether it keeps ZeRO-1 shards or not
(:func:`quickvc_tpu_torch.train.state.optimizer_state_dict`). In a
data-parallel run rank 0 alone writes the files and every rank reads the
same pair on resume.
"""

from __future__ import annotations

import os
import re

import torch


def save_checkpoint(path: str, model: torch.nn.Module, optimizer_state: dict,
                    learning_rate: float, iteration: int) -> None:
    tmp = path + ".tmp"
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "iteration": int(iteration), "optimizer": optimizer_state,
                "learning_rate": float(learning_rate)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: torch.nn.Module) -> tuple[int, dict]:
    """Copy a checkpoint's weights (strictly) into a live model on any
    device; returns its ``iteration`` and its optimizer ``state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    return int(ckpt["iteration"]), ckpt["optimizer"]


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


def prune_checkpoints(model_dir: str, max_to_keep: int, keep=lambda step: False) -> list[int]:
    """Delete the ``G_{step}.pth``/``D_{step}.pth`` files of all but the
    newest ``max_to_keep`` steps, sparing every step for which ``keep(step)``
    holds (those count toward no limit); ``max_to_keep <= 0`` keeps all.
    Returns the steps deleted."""
    if max_to_keep <= 0 or not os.path.isdir(model_dir):
        return []
    steps = sorted({int(m.group(1)) for name in os.listdir(model_dir)
                    if (m := re.fullmatch(r"[GD]_(\d+)\.pth", name)) and not keep(int(m.group(1)))})
    doomed = steps[:-max_to_keep]
    for step in doomed:
        for kind in "GD":
            path = os.path.join(model_dir, f"{kind}_{step}.pth")
            if os.path.exists(path):
                os.remove(path)
    return doomed
