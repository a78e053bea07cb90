"""Offline unit encoding of the PyTorch/CUDA port: HuBERT-soft units for every wav under a tree.

    python -m quickvc_tpu_torch.encode soft in-dir out-dir [--extension .wav]
        [--suffix_16k] [--hubert hubert-soft.pt] [--batch 16]
        [--hubert-front faststats|xla|pallas] [--device cuda|cpu]

The port of ``dataset/encode.py``: saves ``<out-dir>/<rel>.npy``, the
(frames, 256) float32 unit series of each wav (frames = samples // 320 at
16 kHz), the training corpus's sibling units. Each file is read and
resampled to 16 kHz, zero-padded up to whole seconds, and files of one
padded length are encoded together, ``--batch`` to a forward (a ragged
group is padded with zero rows), by ``HubertSoft.units`` under
``torch.inference_mode()``. ``--hubert-front pallas`` runs the extractor
front as kernel K7; every layer's attention core is kernel K2, or with the
Python entry point's ``fused_layer=True`` each whole layer is kernel K8.

Runs on the card unless ``--device cpu`` is given; asking for CUDA on a
machine without a card raises. ``--hubert`` is a bshall ``hubert-soft.pt``
or the JAX package's HuBERT ``.msgpack`` (``scripts/export_params.py``).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from quickvc_tpu_torch.data.audio_io import read_wav, resample
from quickvc_tpu_torch.models.hubert import FRONTS, HubertSoft
from quickvc_tpu_torch.utils.device import resolve_device
from quickvc_tpu_torch.utils.weights import load_hubert

SR = 16000
BUCKET = SR    # pad to whole seconds: a bounded set of batch shapes
HOP = 320      # wave samples per unit frame
LOOP_SPAN = "quickvc_encode_loop"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Encode an audio dataset to HuBERT-soft units.")
    p.add_argument("model", choices=["soft"])
    p.add_argument("in_dir", metavar="in-dir", type=Path)
    p.add_argument("out_dir", metavar="out-dir", type=Path)
    p.add_argument("--extension", default=".wav", type=str)
    p.add_argument("--suffix_16k", action="store_true")
    p.add_argument("--hubert", default="logs/hubert-soft.pt", type=str)
    p.add_argument("--batch", default=16, type=int,
                   help="files per batched HuBERT forward (same-length bucket)")
    p.add_argument("--hubert-front", default="faststats", type=str, choices=FRONTS,
                   help="HuBERT extractor front (models/hubert.py FeatureExtractor)")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.batch < 1:
        p.error("--batch must be at least 1")
    return args


def main(argv=None, fused_layer: bool = False) -> dict:
    """Run the CLI; ``fused_layer`` runs each HuBERT layer as kernel K8.

    Returns a summary: files, batches, audio and wall seconds (model
    loading excluded) and the written paths.
    """
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 everywhere: cuDNN convolutions would otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):  # the checkpoint supplies every tensor
        hubert = HubertSoft(front=args.hubert_front, use_fused_layer=fused_layer)
    load_hubert(args.hubert, hubert)
    hubert = hubert.to(device).eval()

    if args.suffix_16k:
        paths = sorted(args.in_dir.glob("**/*.16k.wav"))
    else:
        paths = sorted(args.in_dir.rglob(f"*{args.extension}"))
    print(f"Encoding {len(paths)} files from {args.in_dir}")

    outputs, batches, audio_seconds = [], 0, 0.0

    def flush(group: list[tuple[Path, np.ndarray]], padded: int) -> None:
        """One forward over a same-bucket group padded to ``--batch`` rows;
        crop and save each file's units."""
        nonlocal batches
        wav = np.zeros((args.batch, padded), np.float32)
        for i, (_, x) in enumerate(group):
            wav[i, : len(x)] = x
        units = hubert.units(torch.from_numpy(wav).to(device)).float().cpu().numpy()
        for i, (out_path, x) in enumerate(group):
            out_path.parent.mkdir(parents=True, exist_ok=True)
            np.save(out_path.with_suffix(".npy"), units[i, : len(x) // HOP])
            outputs.append(out_path.with_suffix(".npy"))
        batches += 1

    t_start = time.time()
    groups: dict[int, list[tuple[Path, np.ndarray]]] = {}
    # the span of the measured wall in a profiler trace (no cost without a profiler)
    with torch.profiler.record_function(LOOP_SPAN), torch.inference_mode():
        for in_path in paths:
            out_path = args.out_dir / in_path.relative_to(args.in_dir)
            wav, sr = read_wav(str(in_path))
            wav = resample(wav, sr, SR)
            audio_seconds += len(wav) / SR
            padded = -(-max(len(wav), BUCKET) // BUCKET) * BUCKET
            groups.setdefault(padded, []).append((out_path, wav))
            if len(groups[padded]) >= args.batch:
                flush(groups.pop(padded), padded)
        for padded, group in sorted(groups.items()):
            flush(group, padded)
    wall = time.time() - t_start
    print(f"{len(paths)} files in {batches} batches, {wall:.2f}s; "
          f"{audio_seconds / max(wall, 1e-9):.1f} audio s per wall s on {device}")
    return {"files": len(paths), "batches": batches, "audio_seconds": audio_seconds,
            "wall_seconds": wall, "outputs": outputs}


if __name__ == "__main__":
    main()
