"""PyTorch port, training slice, data: file lists, the dataset, the bucket
sampler, ``collate_batch`` in both wire formats and the thread loader give
the JAX package's arrays exactly, for one seed, on a small s16 corpus.
"""

import numpy as np
import pytest
from scipy.io import wavfile

HOP = 320


def tiny_config(transfer: str):
    from quickvc_tpu_torch.config import DataConfig, ModelConfig, QuickVCConfig, TrainConfig

    return QuickVCConfig(
        train=TrainConfig(segment_size=2560, max_speclen=32, precision="f32", batch_size=2,
                          transfer=transfer, loader_workers=2),
        data=DataConfig(),
        model=ModelConfig(unit_channels=12))


def write_corpus(root, rng, seconds, unit_channels: int = 12) -> str:
    """s16 wavs under root/spk{i % 2}/ with (frames, unit_channels) unit .npy
    siblings; returns a train.txt listing them."""
    paths = []
    for i, sec in enumerate(seconds):
        spk = root / f"spk{i % 2}"
        spk.mkdir(parents=True, exist_ok=True)
        n = int(sec * 16000)
        wav = (np.sin(np.arange(n) * 0.03 * (i + 1)) * 0.3
               + rng.standard_normal(n) * 0.05)
        path = spk / f"utt{i}.wav"
        wavfile.write(str(path), 16000, (wav * 32767).astype(np.int16))
        np.save(spk / f"utt{i}.npy",
                rng.standard_normal((n // HOP, unit_channels)).astype(np.float32))
        paths.append(str(path))
    listing = root / "train.txt"
    listing.write_text("".join(f"{p}|spk\n" for p in paths))
    return str(listing)


def _both_configs(listing: str, transfer: str):
    from quickvc_tpu.config import config_from_dict as jax_config
    from quickvc_tpu_torch.config import config_from_dict

    d = tiny_config(transfer).to_dict()
    d["data"]["training_files"] = listing
    return config_from_dict(d), jax_config(d)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    return root, write_corpus(root, rng, [0.8, 0.9, 1.05, 0.75, 0.95, 1.3, 0.7])


def test_file_lists_and_dataset_match_jax(corpus):
    from quickvc_tpu.data.dataset import UnitAudioSpecDataset as JaxDataset
    from quickvc_tpu.data.dataset import load_filepaths as jax_lists
    from quickvc_tpu_torch.data.dataset import UnitAudioSpecDataset, load_filepaths

    root, listing = corpus
    for spec in (listing, str(root)):
        for mode in ("train", "eval"):
            assert load_filepaths(spec, mode) == jax_lists(spec, mode)
    cfg, jcfg = _both_configs(listing, "full")
    ours, theirs = UnitAudioSpecDataset("train", cfg), JaxDataset("train", jcfg)
    assert ours.audiopaths == theirs.audiopaths and ours.lengths == theirs.lengths
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys() == {"unit", "spec", "wave"}
        np.testing.assert_array_equal(a["unit"], b["unit"])
        np.testing.assert_array_equal(a["wave"], b["wave"])
        np.testing.assert_allclose(a["spec"], b["spec"], rtol=1e-6)


@pytest.mark.parametrize("transfer", ["full", "compact"])
def test_collate_and_loader_match_jax(corpus, transfer):
    """Same seed -> identical batches: the sampler's order, the collate crops
    and the loader's (seed, epoch, batch index) draws, in both formats."""
    from quickvc_tpu.data.dataset import BucketSampler as JaxSampler
    from quickvc_tpu.data.dataset import DataLoader as JaxLoader
    from quickvc_tpu.data.dataset import UnitAudioSpecDataset as JaxDataset
    from quickvc_tpu.data.dataset import collate_batch as jax_collate
    from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                                UnitAudioSpecDataset, collate_batch)

    _, listing = corpus
    cfg, jcfg = _both_configs(listing, transfer)
    with_spec = transfer == "full"
    ds = UnitAudioSpecDataset("train", cfg, with_spec=with_spec)
    jds = JaxDataset("train", jcfg, with_spec=with_spec)
    items = [ds[i] for i in range(3)]
    ours = collate_batch(items, 40, cfg, np.random.default_rng(5))
    theirs = jax_collate([jds[i] for i in range(3)], 40, jcfg, np.random.default_rng(5))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    sampler = BucketSampler(ds.lengths, 2, BUCKET_BOUNDARIES)
    jsampler = JaxSampler(jds.lengths, 2, BUCKET_BOUNDARIES)
    loader = DataLoader(ds, sampler, cfg, num_workers=2, seed=9)
    jloader = JaxLoader(jds, jsampler, jcfg, num_workers=2, seed=9)
    for epoch in (1, 2):
        sampler.set_epoch(epoch)
        jsampler.set_epoch(epoch)
        assert list(sampler) == list(jsampler) and len(loader) == len(jloader) > 1
        loader.skip_next_iter(1)
        jloader.skip_next_iter(1)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader) - 1
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_compact_batch_holds_the_full_batch(corpus):
    """The compact crop, decoded as the training step does, gives the full
    batch's unit, spectrogram and wave for the same seed."""
    import torch

    from quickvc_tpu_torch.data.dataset import UnitAudioSpecDataset, collate_batch
    from quickvc_tpu_torch.train.step import decode_batch

    _, listing = corpus
    cfg_c, _ = _both_configs(listing, "compact")
    cfg_f, _ = _both_configs(listing, "full")
    idx = [5, 2]  # a long and a short item: one crop, one zero tail
    full = collate_batch([UnitAudioSpecDataset("train", cfg_f)[i] for i in idx], 40, cfg_f,
                         np.random.default_rng(3))
    compact = collate_batch(
        [UnitAudioSpecDataset("train", cfg_c, with_spec=False)[i] for i in idx], 40, cfg_c,
        np.random.default_rng(3))
    as_t = lambda b: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    u_c, s_c, w_c = decode_batch(as_t(compact), cfg_c)
    u_f, s_f, w_f = decode_batch(as_t(full), cfg_f)
    np.testing.assert_array_equal(u_c.numpy(), u_f.numpy())
    np.testing.assert_array_equal(w_c.numpy(), w_f.numpy())
    np.testing.assert_allclose(s_c.numpy(), s_f.numpy(), atol=2e-4, rtol=2e-4)
