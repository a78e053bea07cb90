"""Training data: file lists, the unit/audio dataset, the length-bucketing
sampler, fixed-shape collate and a prefetching loader on threads or processes.

The port's own copy of ``quickvc_tpu/data/dataset.py:38-624`` (reference
``data_utils_new_new.py``). Each utterance is a 16 kHz s16 wav, or any file
the native decoder reads (FLAC), with its HuBERT-soft units in a sibling
``.npy`` of shape (frames, 256).
``collate_batch`` makes the same crop draws in both wire formats:

- ``transfer='full'``: unit (B, L, 256), spec (B, L, 641), wave (B, L*hop, 1),
  all float32, with the spectrogram computed on the host by the plain
  :func:`quickvc_tpu_torch.dsp.stft.wave_to_spec` (and cached);
- ``transfer='compact'``: unit (B, L, 256), the raw int16 crop with the
  STFT halo ``wave_s16`` (B, L*hop + n_fft - hop) and the valid-frame counts
  ``n_take`` (B,); the training step computes the spectrogram on the card
  (kernel K4) and masks past ``n_take``. At ``train.precision: "bf16"`` the
  units ship in bf16, the dtype the step casts them to, as the JAX loader
  ships them (``quickvc_tpu/data/dataset.py:256-268``): numpy has no bf16,
  so the buffers hold the bit patterns as ``uint16``
  (:mod:`quickvc_tpu_torch.utils.bf16`), which the trainer views as
  ``torch.bfloat16`` after its copy.
"""

from __future__ import annotations

import glob
import multiprocessing as mp
import os
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import resource_tracker, shared_memory
from queue import Empty
from typing import Iterator, Sequence

import numpy as np
import torch

from quickvc_tpu_torch.config import QuickVCConfig
from quickvc_tpu_torch.data import native
from quickvc_tpu_torch.data.audio_io import read_audio
from quickvc_tpu_torch.dsp.stft import wave_to_spec
from quickvc_tpu_torch.utils import bf16

BUCKET_BOUNDARIES = [32, 40, 50, 60, 70, 80, 90, 100, 110, 120, 160, 200, 230,
                     260, 300, 350, 400, 450, 500, 600, 700, 800, 900, 1000]


def load_filepaths(list_path: str, mode: str = "train") -> list[str]:
    """Audio paths of a dataset spec: a ``*.txt`` file list (first ``|`` field
    per line), or a ``<root>/<speaker>/<utt>.{wav,flac}`` directory whose last
    utterance per speaker is held out for eval."""
    if list_path.endswith(".txt"):
        with open(list_path, encoding="utf-8") as f:
            return [line.strip().split("|")[0] for line in f if line.strip()]
    paths = sorted(p for ext in ("wav", "flac")
                   for p in glob.glob(os.path.join(list_path, "**", f"*.{ext}"), recursive=True))
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
        """Bucket length in spectrogram frames: a ``.wav``'s from its size (the
        reference's s16 heuristic, exact for the preprocessing step's output);
        any other entry's (FLAC) from the exact frame count in its header,
        since a compressed file's size is no sample count
        (``quickvc_tpu/data/dataset.py:131-153``)."""
        hop = self.cfg.data.hop_length
        if path.lower().endswith(".wav"):
            return os.path.getsize(path) // (2 * hop)
        samples, _ = native.probe(path)
        return samples // hop

    def __len__(self) -> int:
        return len(self.audiopaths)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        path = self.audiopaths[index]
        wav, sr = read_audio(path)
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
    ``DistributedBucketSampler`` semantics; ``quickvc_tpu/data/dataset.py:
    189-258``). With ``num_replicas`` ranks each bucket is padded to a
    multiple of ``batch_size * num_replicas`` items, every global batch of
    that many is split among the ranks by stride, and rank ``rank`` yields its
    ``batch_size`` items of each: the ranks draw the same shuffles and stay in
    lockstep, one batch each per step."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 boundaries: Sequence[int], shuffle: bool = True,
                 num_replicas: int = 1, rank: int = 0):
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.shuffle = shuffle
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        buckets: list[list[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(lengths):
            b = self._bisect(length)
            if b != -1:
                buckets[b].append(i)
        keep = [j for j, b in enumerate(buckets) if b]
        self.buckets = [buckets[j] for j in keep]
        self.bucket_lo = [self.boundaries[j] for j in keep]  # items have len > lo
        total = batch_size * num_replicas
        self.num_samples_per_bucket = [len(b) + (total - len(b) % total) % total
                                       for b in self.buckets]

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
        total = self.batch_size * self.num_replicas
        for k, bucket in enumerate(self.buckets):
            ids = list(g.permutation(len(bucket))) if self.shuffle else list(range(len(bucket)))
            rem = self.num_samples_per_bucket[k] - len(bucket)
            ids = ids + ids * (rem // len(bucket)) + ids[: rem % len(bucket)]
            for j in range(len(ids) // total):
                chunk = ids[j * total : (j + 1) * total]
                mine = chunk[self.rank :: self.num_replicas][: self.batch_size]
                batches.append((k, [bucket[i] for i in mine]))
        if self.shuffle:
            batches = [batches[i] for i in g.permutation(len(batches))]
        return iter(batches)

    def __len__(self) -> int:
        return sum(n // (self.batch_size * self.num_replicas)
                   for n in self.num_samples_per_bucket)


def bf16_wire(cfg: QuickVCConfig) -> bool:
    """True when the units ship as bf16 bits (compact transfer at bf16)."""
    return cfg.train.transfer == "compact" and cfg.train.precision == "bf16"


def collate_shapes(batch: int, bucket_lo: int, cfg: QuickVCConfig) -> dict[str, tuple]:
    """(shape, dtype) of a bucket's assembly buffers (the unit, spec and wave
    buffers keep the trailing frame that the yielded arrays drop)."""
    seg = min(bucket_lo + 1, cfg.train.max_speclen + 1)
    hop = cfg.data.hop_length
    f32 = np.dtype(np.float32)
    if cfg.train.transfer == "compact":
        pad = (cfg.data.filter_length - hop) // 2
        unit = np.dtype(np.uint16) if bf16_wire(cfg) else f32
        return {"unit": ((batch, seg, cfg.model.unit_channels), unit),
                "wave_s16": ((batch, (seg - 1) * hop + 2 * pad), np.dtype(np.int16)),
                "n_take": ((batch,), np.dtype(np.int32))}
    return {"unit": ((batch, seg, cfg.model.unit_channels), f32),
            "spec": ((batch, seg, cfg.spec_channels), f32),
            "wave": ((batch, seg * hop, 1), f32)}


def collate_batch(items: list[dict[str, np.ndarray]], bucket_lo: int,
                  cfg: QuickVCConfig, rng: np.random.Generator,
                  out: dict[str, np.ndarray] | None = None) -> dict[str, np.ndarray]:
    """Sort by length, zero-pad and crop every item to the bucket's fixed
    length L = min(bucket_lo, max_speclen) frames; one ``rng.integers`` draw
    per item, in the same order in both formats. ``out`` (buffers as
    :func:`collate_shapes` gives them) lets process workers assemble straight
    into shared memory."""
    hop = cfg.data.hop_length
    order = np.argsort([-it["unit"].shape[0] for it in items])
    items = [items[i] for i in order]
    seg = min(bucket_lo + 1, cfg.train.max_speclen + 1)
    if out is None:
        out = {k: np.empty(shape, dtype)
               for k, (shape, dtype) in collate_shapes(len(items), bucket_lo, cfg).items()}

    if cfg.train.transfer == "compact":
        pad = (cfg.data.filter_length - hop) // 2
        out_unit, out_w16, out_take = out["unit"], out["wave_s16"], out["n_take"]
        wire = bf16.to_bits if bf16_wire(cfg) else np.asarray
        for i, it in enumerate(items):
            n_frames = min(it["unit"].shape[0], it["wave"].shape[0] // hop)
            start = int(rng.integers(0, max(n_frames - seg, 0) + 1))
            take = min(seg - 1, n_frames)  # valid frames after the trailing drop
            out_unit[i, :take] = wire(it["unit"][start : start + take])
            out_unit[i, take:] = 0     # 0.0 in float32 and in bf16 bits
            # the s16 round trip is exact: the samples came from int16 / 32768
            w16 = np.pad((it["wave"][:, 0] * 32768.0).astype(np.int16), (pad, pad),
                         mode="reflect")
            halo_len = take * hop + 2 * pad
            out_w16[i, :halo_len] = w16[start * hop : start * hop + halo_len]
            out_w16[i, halo_len:] = 0
            out_take[i] = take
        return _crop_trailing(out, cfg)

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
    return _crop_trailing(out, cfg)


def _crop_trailing(full: dict[str, np.ndarray], cfg: QuickVCConfig) -> dict[str, np.ndarray]:
    """Drop the trailing frame (reference data_utils_new_new.py:210-213); the
    compact wave buffer is already sized without it."""
    if cfg.train.transfer == "compact":
        return {"unit": full["unit"][:, :-1], "wave_s16": full["wave_s16"],
                "n_take": full["n_take"]}
    return {"unit": full["unit"][:, :-1], "spec": full["spec"][:, :-1],
            "wave": full["wave"][:, : -cfg.data.hop_length]}


class DataLoader:
    """Whole batches assemble in parallel workers, ``num_workers + prefetch``
    in flight, yielded in sampler order. Crops depend only on (seed, epoch,
    batch index), never on worker timing, so both modes yield bit-identical
    batches:

    - ``mode="thread"``: a thread pool in this process; numpy I/O and copies
      release the GIL.
    - ``mode="process"``: persistent spawn-started worker processes assemble
      each batch into a fresh shared-memory segment; the parent maps it and
      yields numpy views (no pickled array data). A worker imports torch for
      the CPU spectrogram of ``transfer='full'`` but never touches CUDA. A
      yielded batch's arrays stay valid until ``num_workers + 2 * prefetch +
      2`` further batches have been drawn: copy what must live longer.
      :meth:`close` stops the workers.
    """

    def __init__(self, dataset: UnitAudioSpecDataset, sampler: BucketSampler,
                 cfg: QuickVCConfig, num_workers: int = 8, seed: int = 1234,
                 prefetch: int = 2, mode: str = "thread"):
        self._procs: list = []
        if mode not in ("thread", "process"):
            raise ValueError(f"mode must be 'thread' or 'process', got {mode!r}")
        self.dataset, self.sampler, self.cfg = dataset, sampler, cfg
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.mode = mode
        self._skip_next = 0
        self._serial = 0   # the process-mode iteration that tasks and results belong to
        self._task_q = self._result_q = None

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
        if self.mode == "process":
            yield from self._iter_process()
            return
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

    def _start_workers(self) -> None:
        if self._procs:
            return
        ctx = mp.get_context("spawn")
        self._task_q, self._result_q = ctx.Queue(), ctx.Queue()
        for _ in range(self.num_workers):
            p = ctx.Process(target=_process_worker_main, daemon=True,
                            args=(self._task_q, self._result_q, self.dataset, self.cfg,
                                  self.seed))
            p.start()
            self._procs.append(p)

    def _drain(self, timeout: float) -> int:
        """Unlink the segments of results waiting in the queue (a stopped
        iteration's); returns how many results it took."""
        n = 0
        while True:
            try:
                status, _, _, payload = self._result_q.get(timeout=timeout)
            except Empty:
                return n
            n += 1
            if status == "ok":
                _unlink(payload[0])

    def close(self) -> None:
        """Stop the process workers (nothing to do in thread mode), unlinking
        the batches they assembled that were never yielded."""
        if not self._procs:
            return
        for _ in self._procs:
            self._task_q.put(None)
        for _ in range(300):   # about 30 s for the queued batches
            if not any(p.is_alive() for p in self._procs):
                break
            self._drain(timeout=0.1)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        self._drain(timeout=0.1)
        self._procs = []

    def __del__(self):
        self.close()

    def _iter_process(self):
        self._start_workers()
        self._serial += 1
        serial = self._serial
        batches = list(self.sampler)
        epoch = self.sampler.epoch
        in_flight = self.num_workers + self.prefetch
        keep = self.num_workers + 2 * self.prefetch + 2   # yielded segments still mapped
        window: deque = deque()
        pending: dict[int, tuple] = {}
        nxt_submit = nxt_yield = self._skip_next
        self._skip_next = 0
        try:
            while nxt_yield < len(batches):
                while nxt_submit < len(batches) and nxt_submit - nxt_yield < in_flight:
                    k, idxs = batches[nxt_submit]
                    self._task_q.put((serial, nxt_submit, epoch, idxs,
                                      self.sampler.bucket_lo[k]))
                    nxt_submit += 1
                while nxt_yield not in pending:
                    try:
                        status, got, bidx, payload = self._result_q.get(timeout=60)
                    except Empty:
                        if not any(p.is_alive() for p in self._procs):
                            raise RuntimeError("all loader worker processes died "
                                               "(killed?) with batches outstanding") from None
                        continue
                    if got != serial:   # left over from a stopped iteration
                        if status == "ok":
                            _unlink(payload[0])
                        continue
                    if status == "err":
                        raise RuntimeError(f"loader worker failed on batch {bidx}:\n{payload}")
                    pending[bidx] = payload
                name, metas = pending.pop(nxt_yield)
                shm = shared_memory.SharedMemory(name=name)
                window.append(shm)
                full = _views(shm, metas)
                while len(window) > keep:
                    _release(window.popleft())
                yield _crop_trailing(full, self.cfg)
                nxt_yield += 1
        finally:
            while window:
                _release(window.popleft())
            for name, _ in pending.values():
                _unlink(name)


def _release(shm: shared_memory.SharedMemory) -> None:
    """Unlink a yielded segment; unmap it unless the caller still holds
    views of it (then they keep the mapping alive)."""
    shm.unlink()
    try:
        shm.close()
    except BufferError:
        pass


def _unlink(name: str) -> None:
    _release(shared_memory.SharedMemory(name=name))


def _views(shm: shared_memory.SharedMemory, metas) -> dict[str, np.ndarray]:
    """numpy arrays laid end to end in a segment: metas = [(key, shape, dtype name)]."""
    out, off = {}, 0
    for key, shape, dname in metas:
        dt = np.dtype(dname)
        out[key] = np.ndarray(shape, dt, buffer=shm.buf, offset=off)
        off += int(np.prod(shape)) * dt.itemsize
    return out


def _process_worker_main(task_q, result_q, dataset, cfg, seed) -> None:
    """A process worker: each task (iteration, batch index, epoch, item
    indices, bucket floor) becomes a fresh shared-memory segment, handed to
    the parent by name, or the traceback of what failed."""
    while True:
        task = task_q.get()
        if task is None:
            return
        serial, batch_index, epoch, idxs, bucket_lo = task
        try:
            items = [dataset[i] for i in idxs]
            metas = [(k, shape, dtype.name)
                     for k, (shape, dtype) in collate_shapes(len(idxs), bucket_lo, cfg).items()]
            size = sum(int(np.prod(shape)) * np.dtype(d).itemsize for _, shape, d in metas)
            shm = shared_memory.SharedMemory(create=True, size=size)
            out = _views(shm, metas)
            collate_batch(items, bucket_lo, cfg,
                          np.random.default_rng((seed, epoch, batch_index)), out=out)
            del out
            shm.close()
            # the parent unlinks it: keep this process's tracker from doing so too
            resource_tracker.unregister(shm._name, "shared_memory")
            result_q.put(("ok", serial, batch_index, (shm.name, metas)))
        except Exception:
            result_q.put(("err", serial, batch_index, traceback.format_exc()))
