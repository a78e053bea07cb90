"""PyTorch port, process-mode loader workers
(``quickvc_tpu_torch/data/dataset.py:DataLoader(mode="process")``): spawn-
started workers assembling into shared memory yield batches bit-identical to
the thread loader's (the JAX loader's, tests/test_torch_train_data.py) in
both wire formats, over two epochs, with a mid-epoch skip; a worker's
exception reaches the parent with its traceback; an iteration stopped
early costs the next one nothing.
"""

import os

import numpy as np
import pytest

from test_torch_train_data import _both_configs, write_corpus


@pytest.mark.parametrize("transfer", ["full", "compact"])
def test_process_loader_matches_thread_loader(tmp_path, transfer):
    from quickvc_tpu_torch.data.dataset import (BUCKET_BOUNDARIES, BucketSampler, DataLoader,
                                                UnitAudioSpecDataset)

    listing = write_corpus(tmp_path, np.random.default_rng(0),
                           [0.8, 0.9, 1.05, 0.75, 0.95, 1.3, 0.7, 1.2, 0.85])
    cfg, _ = _both_configs(listing, transfer)
    ds = UnitAudioSpecDataset("train", cfg, with_spec=transfer == "full")
    sampler = BucketSampler(ds.lengths, 2, BUCKET_BOUNDARIES)
    thread = DataLoader(ds, sampler, cfg, num_workers=2, seed=9)
    proc = DataLoader(ds, sampler, cfg, num_workers=2, seed=9, mode="process")
    try:
        for epoch, skip in ((1, 0), (2, 2)):
            sampler.set_epoch(epoch)
            thread.skip_next_iter(skip)
            proc.skip_next_iter(skip)
            want = list(thread)
            # a copy: a yielded batch's segment is unlinked a few batches later
            got = [{k: v.copy() for k, v in b.items()} for b in proc]
            assert len(got) == len(want) == len(sampler) - skip > 2
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in b:
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # an iteration stopped early leaves its assembled batches to the next one
        sampler.set_epoch(3)
        next(iter(proc))
        assert len(list(proc)) == len(sampler)

        if transfer == "compact":
            # a worker's failure (a unit file gone) reaches the parent
            os.remove(listing.replace("train.txt", "spk0/utt0.npy"))
            with pytest.raises(RuntimeError, match="loader worker failed(.|\n)*FileNotFound"):
                list(proc)
    finally:
        proc.close()
    assert not proc._procs
