"""PyTorch port, training slice, the whole step on a full-format batch
(``unit``/``spec``/``wave``) against JAX ``make_train_step(debug_grads=True)``
at the tiny config, float32, with the multistream decoder and with the
multiband one (its sub-band STFT loss); the update guard; and the trainer CLI on the
CPU: two steps, a resume to three, and the last generator checkpoint
loading into the converter with ``strict=True``.

Tolerances (tests/test_grad_parity.py's): losses rtol 2e-4 / atol 1e-5,
D and G gradients max relative error 2e-3, the D update within 1% of lr
where the gradient is well determined.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_train_support import MB, check_step_parity, configs, jax_step, make_batch, port_step

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def full_case():
    return jax_step(compact=False)


def test_full_batch_step_matches_jax(full_case):
    check_step_parity(full_case, port_step(full_case))


def test_multiband_step_matches_jax():
    """The multiband decoder's step: its PQMF-synthesised wave through D and
    the mel loss, and the sub-band MR-STFT loss of its pre-synthesis bands
    against the PQMF analysis of the target slice, non-zero, in the G total
    and its gradients (``dec.subband_conv_post`` among them)."""
    case = jax_step(compact=False, model=MB)
    ours = port_step(case)
    assert float(case["metrics"]["loss/g/subband"]) > 0
    assert "dec.subband_conv_post.weight_v" in ours[2]["debug/g_grads"]
    check_step_parity(case, ours)


def test_guard_skips_a_poisoned_step():
    """A NaN batch leaves G and D, and both optimizers' moments, untouched."""
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    _, cfg = configs()
    state = create_train_state(cfg, torch.device("cpu"))
    basis = mel_basis(cfg, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(np.random.default_rng(1), False).items()}
    gen = torch.Generator().manual_seed(0)
    m = train_step(state, batch, basis, generator=gen)
    assert float(m["guard/d_skipped"]) == float(m["guard/g_skipped"]) == 0.0

    def snapshot():
        return [{k: v.detach().clone() for k, v in net.state_dict().items()}
                for net in (state.net_g, state.net_d)] + [
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.state_dict()["state"].items()}
            for opt in (state.optim_g, state.optim_d)]

    before = snapshot()
    poisoned = dict(batch, wave=torch.full_like(batch["wave"], float("nan")))
    m = train_step(state, poisoned, basis, generator=gen)
    assert float(m["guard/d_skipped"]) == float(m["guard/g_skipped"]) == 1.0
    assert state.step == 2  # the step counter advances, as in the JAX step
    for old, new in zip(before, snapshot()):
        assert old.keys() == new.keys()
        for k in old:
            if isinstance(old[k], dict):
                assert all(torch.equal(old[k][s], new[k][s]) for s in old[k]), k
            else:
                assert torch.equal(old[k], new[k]), k


def test_trainer_cli_trains_resumes_and_converts(tmp_path):
    from test_torch_train_data import write_corpus

    from quickvc_tpu_torch.config import ModelConfig
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.train import loop
    from quickvc_tpu_torch.utils.weights import load_generator

    listing = write_corpus(tmp_path / "corpus", np.random.default_rng(4),
                           [0.9, 0.95, 1.0, 0.85])
    _, cfg = configs(eval_interval=2, epochs=5)
    cfg.data.training_files = cfg.data.validation_files = listing
    hpfile = str(tmp_path / "tiny.json")
    cfg.save(hpfile)
    args = ["-c", hpfile, "-m", "run", "-mr", str(tmp_path / "logs"), "--device", "cpu"]
    # the CLI's process with this worker's torch threads (tests/torch_port_support.py):
    # at torch's default of one a core this test took 43 s of an 8-core host, 16 s so
    proc = subprocess.run([sys.executable, "-m", "quickvc_tpu_torch.train", *args,
                           "--max-steps", "2"],
                          cwd=REPO, capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads())))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run_dir = tmp_path / "logs" / "run"
    assert (run_dir / "G_2.pth").exists() and (run_dir / "D_2.pth").exists()
    assert "step 2 " in proc.stdout and "Resumed" not in proc.stdout

    out = loop.main(args + ["--max-steps", "3"])
    assert out["steps"] == 3 and len(out["losses"]) == 1  # resumed at 2, one more step
    assert all(np.isfinite(v) for v in out["losses"][0].values())
    assert "Resumed from checkpoint at step 2" in (run_dir / "train.log").read_text()
    ckpt = torch.load(run_dir / "G_3.pth", weights_only=True)
    assert ckpt.keys() == {"model", "iteration", "optimizer", "learning_rate"}
    assert ckpt["iteration"] == 2  # epoch 2: two batches per epoch

    # the converter's loader (quickvc_tpu_torch/convert.py:load_models) takes it
    with torch.device("meta"):
        net = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, ModelConfig(**{
            k: getattr(cfg.model, k) for k in ModelConfig.__dataclass_fields__}))
    load_generator(str(run_dir / "G_3.pth"), net)
    with torch.no_grad():
        wave = net.eval().infer(torch.randn(1, 12, 10), torch.randn(1, 16), noise_scale=0.0)
    assert wave.shape == (1, 1, 3200) and torch.isfinite(wave).all()


def test_trainer_cuda_without_card_raises(tmp_path):
    from quickvc_tpu_torch.train import loop

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        loop.main(["-mr", str(tmp_path), "--max-steps", "1"])
