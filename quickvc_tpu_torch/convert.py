"""Voice-conversion CLI of the PyTorch/CUDA port.

    python -m quickvc_tpu_torch.convert [--hpfile cfg.json] [--ptfile G.pth]
        [--hubert hubert-soft.pt] [--txtpath convert.txt] [--outdir out]
        [--device cuda|cpu] [--batch 8] [--noise-scale 1.0]
        [--streaming [--chunk-frames 96] [--context-frames 96]]

Reads ``convert.txt`` lines ``title|src|tgt`` and writes each src utterance
in the tgt speaker's voice as a float32 wav (reference ``convert.py``). The
pipeline is the JAX package's ``convert.py``: host read/resample/trim on a
thread pool, 1-s length buckets, target log-mel (kernel K1) and one
d-vector per unique target, HuBERT-soft units (kernel K2 in every layer;
``--hubert-front pallas`` runs the extractor front as kernel K7) and
``SynthesizerTrn.infer`` (kernel K3 in the decoder head) over batches
of ``--batch`` same-bucket sources, outputs cropped to the source's
``n_frames * hop`` samples. ``--streaming`` synthesizes each batch in
windows of ``--chunk-frames`` unit frames with ``--context-frames`` of
context on each side (``infer/streaming.py``: O(chunk) memory, one K3
launch per window); the default context covers the full-width model's
receptive field, so the output equals the batch path's away from the edges.

Runs on the card unless ``--device cpu`` is given; asking for CUDA on a
machine without a card raises. ``--ptfile`` is a reference-layout
``G_*.pth`` and ``--hubert`` a bshall ``hubert-soft.pt``, or either the JAX
package's ``.msgpack`` parameter file (``scripts/export_params.py``).
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from quickvc_tpu_torch.config import load_config
from quickvc_tpu_torch.data.audio_io import read_wav, resample, trim_silence, write_wav
from quickvc_tpu_torch.infer.streaming import streaming_infer
from quickvc_tpu_torch.models.encoders import embed_utterance
from quickvc_tpu_torch.models.hubert import FRONTS, HubertSoft
from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
from quickvc_tpu_torch.ops.fused_mel import wave_to_mel
from quickvc_tpu_torch.utils.device import resolve_device
from quickvc_tpu_torch.utils.weights import load_generator, load_hubert

LOOP_SPAN = "quickvc_convert_loop"


def pad_to_bucket(wav: np.ndarray, bucket: int) -> np.ndarray:
    """Reflect-pad a waveform up to the next multiple of ``bucket`` samples.

    Very short inputs reflect repeatedly (np reflect caps at len-1 per round).
    """
    target = int(np.ceil(max(len(wav), bucket) / bucket)) * bucket
    out = wav
    while len(out) < target:
        take = min(target - len(out), max(len(out) - 1, 1))
        out = np.pad(out, (0, take), mode="reflect" if len(out) > 1 else "edge")
    return out


def load_models(cfg, ptfile: str, hubert_path: str, front: str,
                device: torch.device) -> tuple[SynthesizerTrn, HubertSoft]:
    with torch.device("meta"):  # the checkpoints supply every tensor
        net_g = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
        hubert = HubertSoft(front=front)
    load_generator(ptfile, net_g)
    load_hubert(hubert_path, hubert)
    return net_g.to(device).eval(), hubert.to(device).eval()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hpfile", type=str, default="logs/quickvc/config.json")
    p.add_argument("--ptfile", type=str, default="logs/quickvc/quickvc.pth")
    p.add_argument("--hubert", type=str, default="logs/hubert-soft.pt")
    p.add_argument("--txtpath", type=str, default="convert.txt")
    p.add_argument("--outdir", type=str, default="output/quickvc")
    p.add_argument("--use_timestamp", default=False, action="store_true")
    p.add_argument("--noise-scale", type=float, default=1.0,
                   help="prior sampling noise (0 = deterministic)")
    p.add_argument("--streaming", action="store_true",
                   help="synthesize in fixed-size unit windows: O(chunk) memory for "
                        "any utterance length")
    p.add_argument("--chunk-frames", type=int, default=96,
                   help="unit frames synthesized per window with --streaming")
    p.add_argument("--context-frames", type=int, default=96,
                   help="context frames on each side of a window; must cover the "
                        "model's receptive field (~75 frames at full width: enc_p's "
                        "16-layer WaveNet +-32, the 4x4 flow couplings +-32, the "
                        "decoder ~+-10) for the output to match the batch path")
    p.add_argument("--bucket-seconds", type=float, default=1.0,
                   help="reflect-pad utterances up to this grain so same-length "
                        "sources batch together; 0 = exact lengths")
    p.add_argument("--hubert-front", type=str, default="faststats", choices=FRONTS,
                   help="HuBERT extractor front (models/hubert.py FeatureExtractor)")
    p.add_argument("--batch", type=int, default=8,
                   help="sources per forward within a length bucket; a ragged "
                        "last group is padded to this size")
    p.add_argument("--host-workers", type=int, default=min(8, os.cpu_count() or 1),
                   help="threads for host read/resample/trim and wav writes")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns a summary (pairs, audio and wall seconds, outputs)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 everywhere: cuDNN convolutions would otherwise run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.outdir, exist_ok=True)
    cfg = load_config(args.hpfile)
    sr, hop = cfg.data.sampling_rate, cfg.data.hop_length

    print("Loading model...")
    net_g, hubert = load_models(cfg, args.ptfile, args.hubert, args.hubert_front, device)
    with open(args.txtpath) as f:
        pairs = [line.strip().split("|") for line in f if line.strip()]
    bucket = int(args.bucket_seconds * sr)

    def prep_pair(pair):
        title, src, tgt = pair
        wav_tgt, tsr = read_wav(tgt)
        wav_tgt, _ = trim_silence(resample(wav_tgt, tsr, sr), top_db=20)
        wav_src, ssr = read_wav(src)
        wav_src = resample(wav_src, ssr, sr)
        n_frames = len(wav_src) // hop
        if bucket:
            wav_src = pad_to_bucket(wav_src, bucket)
            wav_tgt = pad_to_bucket(wav_tgt, bucket)
        return {"title": title, "tgt": tgt, "src_wav": wav_src,
                "tgt_wav": wav_tgt, "n_frames": n_frames}

    t_start = time.time()
    outputs, writes, audio_seconds = [], [], 0.0
    # the span of the measured wall in a profiler trace (no cost without a profiler)
    with torch.profiler.record_function(LOOP_SPAN), \
            ThreadPoolExecutor(max(1, args.host_workers)) as host_pool, torch.inference_mode():
        items = list(host_pool.map(prep_pair, pairs))
        t_prep = time.time() - t_start

        # one d-vector per unique target (the reference recomputes it per pair)
        g_cache: dict[str, torch.Tensor] = {}
        for it in items:
            if it["tgt"] not in g_cache:
                wav = torch.from_numpy(it["tgt_wav"][None]).to(device)
                mel = wave_to_mel(wav, sr, cfg.data.filter_length, hop,
                                  cfg.data.win_length, cfg.data.n_mel_channels,
                                  cfg.data.mel_fmin, cfg.data.mel_fmax)
                g_cache[it["tgt"]] = embed_utterance(net_g.enc_spk, mel)

        groups: dict[int, list[dict]] = {}
        for it in items:
            groups.setdefault(len(it["src_wav"]), []).append(it)
        gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
        nb = max(1, args.batch)
        for length in sorted(groups):
            group = groups[length]
            for lo in range(0, len(group), nb):
                chunk = group[lo : lo + nb]
                t0 = time.time()
                padded = chunk + [chunk[-1]] * (nb - len(chunk))
                src = torch.from_numpy(np.stack([it["src_wav"] for it in padded])).to(device)
                g = torch.cat([g_cache[it["tgt"]] for it in padded])
                unit = hubert.units(src).transpose(1, 2)          # (B, 256, F)
                if args.streaming:
                    audio = streaming_infer(net_g, unit, g, hop, args.chunk_frames,
                                            args.context_frames, args.noise_scale, gen)
                else:
                    audio = net_g.infer(unit, g, args.noise_scale, gen)[:, 0]
                audio = audio.float().cpu().numpy()
                dt = time.time() - t0
                for i, it in enumerate(chunk):
                    out = audio[i, : it["n_frames"] * hop] if bucket else audio[i]
                    name = (f"{time.strftime('%m-%d_%H-%M')}_{it['title']}.wav"
                            if args.use_timestamp else f"{it['title']}.wav")
                    path = os.path.join(args.outdir, name)
                    writes.append(host_pool.submit(write_wav, path, out, sr))
                    outputs.append((path, len(out)))
                    audio_seconds += len(out) / sr
                    print(f"{it['title']}: {len(out) / sr:.2f}s audio "
                          f"({len(chunk)}-pair batch in {dt:.2f}s)")
        for w in writes:
            w.result()  # surface any write error before the summary line
    wall = time.time() - t_start
    print(f"{len(items)} pairs in {wall:.2f}s (host prep {t_prep:.2f}s on "
          f"{args.host_workers} workers); {audio_seconds / wall:.1f} audio s "
          f"per wall s on {device}")
    return {"pairs": len(items), "audio_seconds": audio_seconds,
            "wall_seconds": wall, "outputs": outputs}


if __name__ == "__main__":
    main()
