"""PyTorch port, HuBERT-soft: units against the JAX package in both extractor
fronts at a tiny config (2 layers x 64-d x 4 heads), and the bshall key
contract at full size. Tolerance atol 1e-4 / rtol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import t, tiny_hubert


@pytest.mark.parametrize("front", ["faststats", "xla"])
def test_units_match_jax(rng, front):
    from quickvc_tpu.models.hubert import HubertSoft as JaxHubert

    jnet, params, port = tiny_hubert(front)
    wav = rng.standard_normal((2, 8003)).astype(np.float32) * 0.3
    units = jax.jit(lambda p, w: jnet.apply({"params": p}, w, method=JaxHubert.units))
    golden = np.asarray(units(params, jnp.asarray(wav)))
    with torch.no_grad():
        ours = port.units(t(wav)).numpy()
    assert ours.shape == golden.shape == (2, 8003 // 320, 24)
    np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)


def test_state_dict_inverts_jax_port():
    """hubert_state_dict_from_jax is the inverse of quickvc_tpu's port_hubert."""
    from quickvc_tpu.utils.hubert_port import port_hubert
    from quickvc_tpu_torch.utils.weights import hubert_state_dict_from_jax

    _, params, _ = tiny_hubert("xla")
    sd = {k: v.numpy() for k, v in hubert_state_dict_from_jax(params).items()}
    back = port_hubert(sd, num_layers=2)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path], err_msg=str(path))


def test_full_size_keys_follow_bshall_contract():
    from quickvc_tpu.utils.hubert_port import expected_hubert_sd_shapes
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.utils.weights import validate_hubert_sd

    with torch.device("meta"):
        sd = HubertSoft().state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == expected_hubert_sd_shapes()
    validate_hubert_sd(sd)
    sd.pop("proj.bias")
    with pytest.raises(ValueError, match="missing=\\['proj.bias'\\]"):
        validate_hubert_sd(sd)
