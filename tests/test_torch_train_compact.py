"""PyTorch port, training slice, the whole step on a compact batch
(``unit``/``wave_s16``/``n_take``: the spectrogram made in the step by K4's
plain version on the CPU, frames and samples past ``n_take`` masked) against
JAX ``make_train_step(debug_grads=True)`` at the tiny config, float32.

Tolerances as tests/test_torch_train_step.py.
"""

import pytest

from torch_train_support import check_step_parity, jax_step, port_step


@pytest.fixture(scope="module")
def compact_case():
    return jax_step(compact=True)


def test_compact_batch_step_matches_jax(compact_case):
    from quickvc_tpu_torch.ops import fused_mel

    before = fused_mel.SPEC_STATS.launches
    ours = port_step(compact_case)
    assert fused_mel.SPEC_STATS.launches == before  # CPU tensors: the plain version
    check_step_parity(compact_case, ours)
