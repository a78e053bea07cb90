"""Training data: file lists, the unit/audio dataset, the length-bucketing
sampler, fixed-shape collate and a prefetching thread loader.

The port's own copy of ``quickvc_tpu/data/dataset.py:38-375`` (reference
``data_utils_new_new.py``). Each utterance is a 16 kHz s16 wav
with its HuBERT-soft units in a sibling ``.npy`` of shape (frames, 256).
``collate_batch`` makes the same crop draws in both wire formats:

- ``transfer='full'``: unit (B, L, 256), spec (B, L, 641), wave (B, L*hop, 1),
  all float32, with the spectrogram computed on the host by the plain
  :func:`quickvc_tpu_torch.dsp.stft.wave_to_spec` (and cached);
- ``transfer='compact'``: unit (B, L, 256), the raw int16 crop with the
  STFT halo ``wave_s16`` (B, L*hop + n_fft - hop) and the valid-frame counts
  ``n_take`` (B,); the training step computes the spectrogram on the card
  (kernel K4) and masks past ``n_take``.

Only the thread loader is ported (the trainer refuses ``loader_mode='process'``).
"""

from __future__ import annotations

import glob
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from quickvc_tpu_torch.config import QuickVCConfig
from quickvc_tpu_torch.data.audio_io import read_wav
from quickvc_tpu_torch.dsp.stft import wave_to_spec

BUCKET_BOUNDARIES = [32, 40, 50, 60, 70, 80, 90, 100, 110, 120, 160, 200, 230,
                     260, 300, 350, 400, 450, 500, 600, 700, 800, 900, 1000]


def load_filepaths(list_path: str, mode: str = "train") -> list[str]:
    """Wav paths of a dataset spec: a ``*.txt`` file list (first ``|`` field
    per line), or a ``<root>/<speaker>/<utt>.wav`` directory whose last
    utterance per speaker is held out for eval."""
    if list_path.endswith(".txt"):
        with open(list_path, encoding="utf-8") as f:
            return [line.strip().split("|")[0] for line in f if line.strip()]
    paths = sorted(glob.glob(os.path.join(list_path, "**", "*.wav"), recursive=True))
    by_spk: dict[str, list[str]] = {}
    for p in paths:
        by_spk.setdefault(os.path.basename(os.path.dirname(p)), []).append(p)
    out: list[str] = []
    for spk in sorted(by_spk):
        utts = by_spk[spk]
        out.extend(utts[:-1] if mode == "train" else utts[-1:])
    return out


def _sibling(path: str, new_suffix: str) -> str:
    return os.path.splitext(path)[0] + new_suffix


class UnitAudioSpecDataset:
    """Per-utterance {unit, wave[, spec]} with an on-disk spectrogram cache."""

    def __init__(self, mode: str, cfg: QuickVCConfig, shuffle_seed: int = 1243,
                 cache_specs: bool = True, with_spec: bool = True):
        self.cfg = cfg
        self.with_spec = with_spec
        list_path = cfg.data.training_files if mode == "train" else cfg.data.validation_files
        self.audiopaths = load_filepaths(list_path, mode)
        np.random.default_rng(shuffle_seed).shuffle(self.audiopaths)
        self.cache_specs = cache_specs
        d = cfg.data
        self.spec_suffix = f".spec-{d.filter_length}-{d.hop_length}-{d.win_length}.npy"
        self.lengths = [self._estimate_frames(p) for p in self.audiopaths]

    def _estimate_frames(self, path: str) -> int:
        """Frames from the s16 wav's size (the reference's heuristic)."""
        if not path.lower().endswith(".wav"):
            raise NotImplementedError(f"{path}: the port reads s16 wav corpora only")
        return os.path.getsize(path) // (2 * self.cfg.data.hop_length)

    def __len__(self) -> int:
        return len(self.audiopaths)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        path = self.audiopaths[index]
        wav, sr = read_wav(path)
        if sr != self.cfg.data.sampling_rate:
            raise ValueError(f"{path}: {sr} Hz, config says {self.cfg.data.sampling_rate}")
        unit = np.load(_sibling(path, ".npy")).astype(np.float32, copy=False)
        item = {"unit": unit, "wave": wav[:, None]}
        if not self.with_spec:
            return item
        spec_path = _sibling(path, self.spec_suffix)
        if self.cache_specs and os.path.exists(spec_path):
            item["spec"] = np.load(spec_path)
            return item
        d = self.cfg.data
        item["spec"] = wave_to_spec(torch.from_numpy(wav), d.filter_length, d.hop_length,
                                    d.win_length).numpy()
        if self.cache_specs:
            # a unique name per writer: repeated indices may load concurrently
            tmp = f"{spec_path}.tmp.{os.getpid()}.{threading.get_ident()}.npy"
            np.save(tmp, item["spec"])
            os.replace(tmp, spec_path)
        return item


class BucketSampler:
    """Length-bucketed batches with epoch-seeded shuffles (reference
    ``DistributedBucketSampler`` semantics, one replica)."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 boundaries: Sequence[int], shuffle: bool = True):
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.shuffle = shuffle
        self.epoch = 0
        buckets: list[list[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(lengths):
            b = self._bisect(length)
            if b != -1:
                buckets[b].append(i)
        keep = [j for j, b in enumerate(buckets) if b]
        self.buckets = [buckets[j] for j in keep]
        self.bucket_lo = [self.boundaries[j] for j in keep]  # items have len > lo
        self.num_samples_per_bucket = [
            len(b) + (batch_size - len(b) % batch_size) % batch_size for b in self.buckets]

    def _bisect(self, x: int) -> int:
        lo, hi = 0, len(self.boundaries) - 1
        while hi > lo:
            mid = (hi + lo) // 2
            if self.boundaries[mid] < x <= self.boundaries[mid + 1]:
                return mid
            if x <= self.boundaries[mid]:
                hi = mid
            else:
                lo = mid + 1
        return -1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[tuple[int, list[int]]]:
        """Yields (bucket_index, item_indices)."""
        g = np.random.default_rng(self.epoch)
        batches: list[tuple[int, list[int]]] = []
        for k, bucket in enumerate(self.buckets):
            ids = list(g.permutation(len(bucket))) if self.shuffle else list(range(len(bucket)))
            rem = self.num_samples_per_bucket[k] - len(bucket)
            ids = ids + ids * (rem // len(bucket)) + ids[: rem % len(bucket)]
            for j in range(len(ids) // self.batch_size):
                chunk = ids[j * self.batch_size : (j + 1) * self.batch_size]
                batches.append((k, [bucket[i] for i in chunk]))
        if self.shuffle:
            batches = [batches[i] for i in g.permutation(len(batches))]
        return iter(batches)

    def __len__(self) -> int:
        return sum(n // self.batch_size for n in self.num_samples_per_bucket)


def collate_shapes(batch: int, bucket_lo: int, cfg: QuickVCConfig) -> dict[str, tuple]:
    """(shape, dtype) of a bucket's assembly buffers (the unit, spec and wave
    buffers keep the trailing frame that the yielded arrays drop)."""
    seg = min(bucket_lo + 1, cfg.train.max_speclen + 1)
    hop = cfg.data.hop_length
    f32 = np.dtype(np.float32)
    if cfg.train.transfer == "compact":
        pad = (cfg.data.filter_length - hop) // 2
        return {"unit": ((batch, seg, cfg.model.unit_channels), f32),
                "wave_s16": ((batch, (seg - 1) * hop + 2 * pad), np.dtype(np.int16)),
                "n_take": ((batch,), np.dtype(np.int32))}
    return {"unit": ((batch, seg, cfg.model.unit_channels), f32),
            "spec": ((batch, seg, cfg.spec_channels), f32),
            "wave": ((batch, seg * hop, 1), f32)}


def collate_batch(items: list[dict[str, np.ndarray]], bucket_lo: int,
                  cfg: QuickVCConfig, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Sort by length, zero-pad and crop every item to the bucket's fixed
    length L = min(bucket_lo, max_speclen) frames; one ``rng.integers`` draw
    per item, in the same order in both formats."""
    hop = cfg.data.hop_length
    order = np.argsort([-it["unit"].shape[0] for it in items])
    items = [items[i] for i in order]
    seg = min(bucket_lo + 1, cfg.train.max_speclen + 1)
    out = {k: np.empty(shape, dtype)
           for k, (shape, dtype) in collate_shapes(len(items), bucket_lo, cfg).items()}

    if cfg.train.transfer == "compact":
        pad = (cfg.data.filter_length - hop) // 2
        out_unit, out_w16, out_take = out["unit"], out["wave_s16"], out["n_take"]
        for i, it in enumerate(items):
            n_frames = min(it["unit"].shape[0], it["wave"].shape[0] // hop)
            start = int(rng.integers(0, max(n_frames - seg, 0) + 1))
            take = min(seg - 1, n_frames)  # valid frames after the trailing drop
            out_unit[i, :take] = it["unit"][start : start + take]
            out_unit[i, take:] = 0.0
            # the s16 round trip is exact: the samples came from int16 / 32768
            w16 = np.pad((it["wave"][:, 0] * 32768.0).astype(np.int16), (pad, pad),
                         mode="reflect")
            halo_len = take * hop + 2 * pad
            out_w16[i, :halo_len] = w16[start * hop : start * hop + halo_len]
            out_w16[i, halo_len:] = 0
            out_take[i] = take
        return {"unit": out_unit[:, :-1], "wave_s16": out_w16, "n_take": out_take}

    out_unit, out_spec, out_wave = out["unit"], out["spec"], out["wave"]
    for i, it in enumerate(items):
        n_frames = min(it["unit"].shape[0], it["spec"].shape[0], it["wave"].shape[0] // hop)
        start = int(rng.integers(0, max(n_frames - seg, 0) + 1))
        take = min(seg, n_frames)
        out_unit[i, :take] = it["unit"][start : start + take]
        out_spec[i, :take] = it["spec"][start : start + take]
        out_wave[i, : take * hop] = it["wave"][start * hop : (start + take) * hop]
        out_unit[i, take:] = 0.0
        out_spec[i, take:] = 0.0
        out_wave[i, take * hop:] = 0.0
    # drop the trailing frame (reference data_utils_new_new.py:210-213)
    return {"unit": out_unit[:, :-1], "spec": out_spec[:, :-1], "wave": out_wave[:, :-hop]}


class DataLoader:
    """Whole batches assemble in a thread pool, ``num_workers + prefetch`` in
    flight, yielded in sampler order. numpy I/O and copies release the GIL.
    Crops depend only on (seed, epoch, batch index), never on thread timing.
    """

    def __init__(self, dataset: UnitAudioSpecDataset, sampler: BucketSampler,
                 cfg: QuickVCConfig, num_workers: int = 8, seed: int = 1234,
                 prefetch: int = 2):
        self.dataset, self.sampler, self.cfg = dataset, sampler, cfg
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self._skip_next = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def skip_next_iter(self, n: int) -> None:
        """Start the next iteration at batch ``n`` (a mid-epoch resume); the
        remaining batches keep their indices, so their crops are unchanged."""
        self._skip_next = int(n)

    def _assemble(self, batch_index: int, bucket: int, idxs: list[int]) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.sampler.epoch, batch_index))
        return collate_batch([self.dataset[i] for i in idxs],
                             self.sampler.bucket_lo[bucket], self.cfg, rng)

    def __iter__(self):
        batches = list(self.sampler)
        in_flight = self.num_workers + self.prefetch
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque()
            nxt, self._skip_next = self._skip_next, 0
            while nxt < len(batches) or pending:
                while nxt < len(batches) and len(pending) < in_flight:
                    k, idxs = batches[nxt]
                    pending.append(pool.submit(self._assemble, nxt, k, idxs))
                    nxt += 1
                yield pending.popleft().result()
