"""Preprocessing CLI of the port: trim, peak-normalise and resample a WAV or
FLAC tree to 16 kHz s16 WAV.

    python -m quickvc_tpu_torch.downsample --in-dir <tree> [--out-dir <tree>]
        [--extension .flac] [--num-workers N]

The port of the repo's root ``downsample.py`` (reference ``downsample.py``),
with the same flags and pipeline: read (FLAC and WAV through the native
decoder, :mod:`quickvc_tpu_torch.data.native`), trim at 20 dB, peak 0.95,
resample to 16 kHz, write 16-bit PCM. Outputs mirror the input tree under
``--out-dir`` with a ``.wav`` suffix, or sit beside the inputs as
``.16k.wav`` when no out-dir is given. The decoder is built before any file
is read, so a machine that cannot build it stops with the compiler's
output; a file the decoder refuses is reported and skipped, as the root
script does.
"""

from __future__ import annotations

import argparse
import os
from multiprocessing import Pool, cpu_count
from pathlib import Path

from quickvc_tpu_torch.data import native
from quickvc_tpu_torch.data.audio_io import (peak_normalize, read_audio, resample,
                                             trim_silence, write_wav_int16)

TARGET_SR = 16000


def process_one(job: tuple[str, str]) -> str | None:
    """One file: read, trim, normalise, resample, write; a message if skipped."""
    in_path, out_path = job
    try:
        wav, sr = read_audio(in_path)
    except (OSError, ValueError) as e:
        return f"skip {in_path}: {e}"
    wav, _ = trim_silence(wav, top_db=20)
    wav = peak_normalize(wav, 0.95)
    wav = resample(wav, sr, TARGET_SR)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    write_wav_int16(out_path, wav, TARGET_SR)
    return None


def jobs_for(in_dir: str, out_dir: str | None, extension: str) -> list[tuple[str, str]]:
    """(input, output) pairs of every ``*extension`` file under ``in_dir``."""
    jobs = []
    for p in sorted(Path(in_dir).rglob(f"*{extension}")):
        if out_dir:
            out = Path(out_dir) / p.relative_to(in_dir).with_suffix(".wav")
        else:
            out = p.with_suffix(".16k.wav")
        jobs.append((str(p), str(out)))
    return jobs


def main(argv=None) -> list[tuple[str, str]]:
    """Run the CLI; returns the (input, output) pairs it processed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--in-dir", required=True, type=str)
    parser.add_argument("--out-dir", default=None, type=str,
                        help="default: write .16k.wav beside inputs")
    parser.add_argument("--extension", default=".wav", type=str)
    parser.add_argument("--num-workers", default=max(1, cpu_count() - 2), type=int)
    args = parser.parse_args(argv)

    native.library()   # built (or refused) once, before the workers fork
    jobs = jobs_for(args.in_dir, args.out_dir, args.extension)
    with Pool(args.num_workers) as pool:
        for msg in pool.imap_unordered(process_one, jobs):
            if msg:
                print(msg)
    print(f"done: {len(jobs)} files")
    return jobs


if __name__ == "__main__":
    main()
