"""PyTorch port, offline unit encoding: the plain versions of kernels K7
(extractor front) and K8 (whole transformer layer) against the JAX package's
Pallas kernels in interpret mode, the tiny HuBERT with both options against
JAX units, and the encode CLI on a tiny corpus on the CPU.

Tolerances: K7 atol 5e-4 / rtol 1e-3 and K8 atol 2e-5 / rtol 1e-4 (the JAX
package's own gates in tests/test_pallas.py: float32 sums in another order,
and the TPU kernel's A&S erf polynomial, |err| <= 1.5e-7, against exact
erf); units atol 1e-4 / rtol 1e-3 (tests/test_torch_hubert.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_support import TINY_HUBERT, t, tiny_hubert


def _pallas_interpret(fn, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


def _jax_units(jnet):
    from quickvc_tpu.models.hubert import HubertSoft as JaxHubert

    return jax.jit(lambda p, w: jnet.apply({"params": p}, w, method=JaxHubert.units))


@pytest.mark.parametrize("t_len", [8083, 16003])
def test_extractor_front_plain_matches_jax(rng, t_len):
    """K7's plain version == JAX fused_extractor_front (interpret mode) at 32
    channels; a CPU tensor launches no kernel."""
    from quickvc_tpu.ops.fused_extractor import fused_extractor_front
    from quickvc_tpu_torch.ops import fused_extractor

    c = TINY_HUBERT["extractor_channels"]
    wav = rng.standard_normal((2, t_len)).astype(np.float32) * 0.3
    w0 = rng.standard_normal((10, 1, c)).astype(np.float32) * 0.3      # JAX (k, in, out)
    gamma = 1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)
    beta = 0.1 * rng.standard_normal(c).astype(np.float32)
    w1 = (rng.standard_normal((3, c, c)) / np.sqrt(3 * c)).astype(np.float32)
    golden = np.asarray(_pallas_interpret(
        fused_extractor_front, *(jnp.asarray(a) for a in (wav, w0, gamma, beta, w1))))
    before = fused_extractor.STATS.launches
    ours = fused_extractor.extractor_front(
        t(wav), t(w0.transpose(2, 1, 0)), t(gamma), t(beta), t(w1.transpose(2, 1, 0)))
    assert fused_extractor.STATS.launches == before
    n1 = fused_extractor.front_rows(t_len)
    assert ours.shape == golden.shape == (2, n1, c)
    np.testing.assert_allclose(ours.numpy(), golden, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("t_len", [70, 257])
def test_transformer_layer_plain_matches_jax(rng, t_len):
    """K8's plain version == JAX fused_transformer_layer (interpret mode) at
    64-d x 4 heads, and == the port's unfused layer."""
    from quickvc_tpu.ops.fused_transformer import fused_transformer_layer
    from quickvc_tpu_torch.ops import fused_transformer

    _, params, port = tiny_hubert("faststats", seed=7, fused_layer=True)
    layer = port.encoder.layers[0]
    x = rng.standard_normal((2, t_len, TINY_HUBERT["embed_dim"])).astype(np.float32) * 0.5
    golden = np.asarray(_pallas_interpret(
        fused_transformer_layer, jnp.asarray(x), params["layer_0"], TINY_HUBERT["num_heads"]))
    before = fused_transformer.STATS.launches
    with torch.no_grad():
        ours = layer(t(x)).numpy()
        layer.use_fused_layer = False
        unfused = layer(t(x)).numpy()
    assert fused_transformer.STATS.launches == before
    assert ours.shape == golden.shape == x.shape
    np.testing.assert_allclose(ours, golden, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ours, unfused, atol=2e-5, rtol=1e-4)


def test_units_with_pallas_front_and_fused_layer_match_jax(rng):
    """front='pallas' and use_fused_layer=True against JAX's pallas front and
    use_pallas_layer (their XLA paths off the TPU)."""
    jnet, params, port = tiny_hubert("pallas", seed=8, fused_layer=True)
    wav = rng.standard_normal((2, 8003)).astype(np.float32) * 0.3
    golden = np.asarray(_jax_units(jnet)(params, jnp.asarray(wav)))
    with torch.no_grad():
        ours = port.units(t(wav)).numpy()
    assert ours.shape == golden.shape == (2, 8003 // 320, TINY_HUBERT["unit_dim"])
    np.testing.assert_allclose(ours, golden, atol=1e-4, rtol=1e-3)


def _corpus(tmp_path, rng):
    """Three wavs: two in the 1-s bucket (one at 22.05 kHz, in a subfolder)
    and one in the 2-s bucket."""
    from quickvc_tpu_torch.data.audio_io import write_wav

    root = tmp_path / "wavs"
    (root / "sub").mkdir(parents=True)
    files = {"a": (root / "a.wav", 9600, 16000), "b": (root / "sub" / "b.wav", 19845, 22050),
             "c": (root / "c.wav", 20800, 16000)}
    for path, n, sr in files.values():
        write_wav(str(path), (rng.standard_normal(n) * 0.3).astype(np.float32), sr)
    return root, files


def test_encode_cli_matches_jax_on_cpu(tmp_path, rng, monkeypatch):
    """The encode CLI at the tiny config, pallas front and fused layer: each
    .npy equals JAX units of its zero-padded bucket wave, cropped; a file in a
    ragged group (--batch 3) gives the units it gives in a full one (--batch 2)."""
    from quickvc_tpu_torch import encode
    from quickvc_tpu_torch.data.audio_io import read_wav, resample
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.utils import weights

    jnet, params, port = tiny_hubert("pallas", seed=9)
    hubert_pt = tmp_path / "hubert-soft.pt"
    torch.save({"hubert": port.state_dict()}, hubert_pt)
    # the CLI builds HuBERT-base and checks the bshall shapes: both at the tiny widths
    h = TINY_HUBERT
    monkeypatch.setattr(encode, "HubertSoft", functools.partial(HubertSoft, **h))
    monkeypatch.setattr(weights, "expected_hubert_sd_shapes", functools.partial(
        weights.expected_hubert_sd_shapes, embed_dim=h["embed_dim"], ffn_dim=h["ffn_dim"],
        unit_dim=h["unit_dim"], conv_dim=h["extractor_channels"],
        pos_kernel=h["pos_kernel_size"], pos_groups=h["pos_groups"]))
    root, files = _corpus(tmp_path, rng)

    def run(out, batch):
        return encode.main(["soft", str(root), str(out), "--hubert", str(hubert_pt),
                            "--hubert-front", "pallas", "--batch", str(batch),
                            "--device", "cpu"], fused_layer=True)

    full = run(tmp_path / "units2", 2)
    ragged = run(tmp_path / "units3", 3)
    assert (full["files"], full["batches"], ragged["batches"]) == (3, 2, 2)

    units_fn = _jax_units(jnet)
    waves = {k: resample(*read_wav(str(path)), 16000) for k, (path, _, _) in files.items()}
    for keys, padded in ((("a", "b"), 16000), (("c",), 32000)):
        batch = np.zeros((len(keys), padded), np.float32)
        for i, k in enumerate(keys):
            batch[i, : len(waves[k])] = waves[k]
        golden = np.asarray(units_fn(params, jnp.asarray(batch)))
        for i, k in enumerate(keys):
            rel = files[k][0].relative_to(root).with_suffix(".npy")
            ours = np.load(tmp_path / "units2" / rel)
            assert ours.dtype == np.float32
            assert ours.shape == (len(waves[k]) // 320, TINY_HUBERT["unit_dim"])
            np.testing.assert_allclose(ours, golden[i, : len(ours)], atol=1e-4, rtol=1e-3)
            np.testing.assert_allclose(np.load(tmp_path / "units3" / rel), ours,
                                       atol=1e-6, rtol=1e-5)


def test_encode_cli_cuda_without_card_raises(tmp_path):
    """The default --device cuda never falls back to the CPU."""
    from quickvc_tpu_torch import encode

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        encode.main(["soft", str(tmp_path), str(tmp_path / "out")])
