"""Export a training run's parameters for serving or interop (port of
``scripts/export_params.py``).

    python -m quickvc_tpu_torch.scripts.export_params --model-dir logs/quickvc --out g.msgpack
    python -m quickvc_tpu_torch.scripts.export_params --model-dir logs/quickvc --format torch \\
        --out G_export.pth --disc-out D_export.pth
    python -m quickvc_tpu_torch.scripts.export_params --hubert-in hubert-soft.pt \\
        --hubert-out hubert.msgpack
    python convert.py --ptfile g.msgpack --hubert hubert.msgpack ...   # the JAX package

Reads ``model_dir/config.json`` and the newest ``G_{n}.pth``/``D_{n}.pth``
pair the trainer wrote (``utils/checkpoint.py:latest_step``). ``n`` is the
number of updates taken: the JAX trainer's checkpoint after the same
updates carries the step ``n - 1``.

- ``--format msgpack`` (default): the generator's JAX parameter tree
  (``utils/weights.py:generator_params_from_state_dict``), its keys sorted
  as ``jax.device_get`` leaves them, written as ``flax.serialization.to_bytes``
  writes it (``utils/msgpack_params.py``): the bytes of the JAX exporter's
  file for the same weights, which the JAX package's ``convert.py
  --ptfile`` and the port's ``--ptfile`` both read.
- ``--format torch``: a reference-schema checkpoint ``{"model",
  "iteration", "optimizer": None, "learning_rate"}`` (the config's base
  learning rate), as the JAX package's ``save_reference_checkpoint`` writes
  it: the parameters only, without the decoder's constant buffers
  (``dec.updown_filter``, any ``dec.*stft.window`` or ``dec.pqmf.*``) and
  without optimizer state. ``--disc-out`` also writes the discriminator.
- ``--hubert-in X.pt --hubert-out X.msgpack``: a bshall HuBERT-soft
  checkpoint (checked against its key contract) as the JAX parameter tree,
  the same way; no ``--model-dir`` needed then.

Runs on the host only: checkpoints are read with ``map_location="cpu"``,
nothing touches a card, and neither ``msgpack`` nor ``flax`` is imported.
"""

from __future__ import annotations

import argparse
import os

import torch

from quickvc_tpu_torch.config import load_config
from quickvc_tpu_torch.utils.checkpoint import latest_step
from quickvc_tpu_torch.utils.msgpack_params import save_params, sorted_tree
from quickvc_tpu_torch.utils.weights import (decoder_buffer, generator_params_from_state_dict,
                                             hubert_params_from_state_dict)


def _model_sd(path: str) -> dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt


def save_reference_checkpoint(path: str, sd: dict, iteration: int, learning_rate: float) -> None:
    """A reference-schema ``.pth`` with no optimizer state."""
    torch.save({"model": {k: v.detach().cpu().contiguous() for k, v in sd.items()},
                "iteration": int(iteration), "optimizer": None,
                "learning_rate": float(learning_rate)}, path)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export the parameters of a port training run.")
    p.add_argument("--model-dir", default=None,
                   help="training dir holding config.json and G_{n}.pth/D_{n}.pth, n the "
                        "updates taken (the JAX trainer names the same state n - 1)")
    p.add_argument("--out", default=None)
    p.add_argument("--hubert-in", default=None, help="bshall HuBERT-soft checkpoint to convert")
    p.add_argument("--hubert-out", default=None, help="write HuBERT's JAX params as .msgpack")
    p.add_argument("--format", choices=["msgpack", "torch"], default="msgpack")
    p.add_argument("--disc-out", default=None,
                   help="with --format torch: also write the discriminator .pth")
    args = p.parse_args(argv)
    if args.hubert_in and not args.hubert_out:
        p.error("--hubert-in requires --hubert-out")
    if (args.model_dir or not args.hubert_in) and not (args.model_dir and args.out):
        p.error("--model-dir and --out required")
    return args


def main(argv=None) -> dict:
    """Returns what was written: {"hubert", "step", "generator", "discriminator"}."""
    args = parse_args(argv)
    out = {}
    if args.hubert_in:
        ckpt = torch.load(args.hubert_in, map_location="cpu", weights_only=True)
        sd = ckpt.get("hubert", ckpt) if isinstance(ckpt, dict) else ckpt
        sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
        save_params(args.hubert_out, sorted_tree(hubert_params_from_state_dict(sd)))
        print(f"exported HuBERT params to {args.hubert_out}")
        out["hubert"] = args.hubert_out
        if not args.model_dir:
            return out
    cfg = load_config(os.path.join(args.model_dir, "config.json"))
    step = latest_step(args.model_dir)
    if step is None:
        raise SystemExit(f"no G_*.pth/D_*.pth pair under {args.model_dir}")
    out["step"] = step
    g_sd = _model_sd(os.path.join(args.model_dir, f"G_{step}.pth"))
    if args.format == "torch":
        lr = cfg.train.learning_rate
        save_reference_checkpoint(args.out, {k: v for k, v in g_sd.items()
                                             if not decoder_buffer(k)}, step, lr)
        print(f"exported the generator after {step} updates to {args.out} (reference layout)")
        out["generator"] = args.out
        if args.disc_out:
            save_reference_checkpoint(args.disc_out,
                                      _model_sd(os.path.join(args.model_dir, f"D_{step}.pth")),
                                      step, lr)
            print(f"exported the discriminator after {step} updates to {args.disc_out}")
            out["discriminator"] = args.disc_out
        return out
    save_params(args.out, sorted_tree(generator_params_from_state_dict(g_sd, cfg.model)))
    print(f"exported the generator params after {step} updates to {args.out}")
    out["generator"] = args.out
    return out


if __name__ == "__main__":
    main()
