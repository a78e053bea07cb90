"""PyTorch port, the parameter exporter
(``python -m quickvc_tpu_torch.scripts.export_params``).

The pure-Python ``.msgpack`` writer (``utils/msgpack_params.py:packb``)
against ``flax.serialization.to_bytes`` byte for byte on seeded trees
(float32, bfloat16, ints, numpy scalars, nesting; flax's chunked leaves with
both chunk limits lowered), and read back by the port's reader; the inverse
weight mappings (``utils/weights.py``) against the JAX package's
``port_generator`` for the three decoders and ``port_hubert``, bit for bit
and in their key order; the CLI on a tiny port training run: its
``.msgpack`` equal to the JAX exporter's bytes for the same weights, read by
the root ``convert.py`` loader, whose JAX ``infer`` matches the port's on
the checkpoint (max-abs <= 1e-3 x max|ref|, as ``tests/test_torch_models.py``);
``--format torch --disc-out`` equal to the JAX package's reference-layout
export and loading strictly into the port's models; HuBERT's ``.msgpack``
equal to the JAX exporter's.
"""

import functools

import numpy as np
import pytest
import torch

import flax.serialization

from torch_port_support import DECODER_FLAGS, TINY_HUBERT, TINY_MODEL, tiny_generator


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == np.ascontiguousarray(b).tobytes())


def _same_tree(ours: dict, golden: dict, path: str = "") -> None:
    """The same keys in the same order at every level, leaves bit-equal."""
    assert list(ours) == list(golden), path
    for k, v in ours.items():
        if isinstance(v, dict):
            _same_tree(v, golden[k], f"{path}/{k}")
        else:
            assert v.dtype == np.float32 and _bits_equal(v, golden[k]), f"{path}/{k}"


def _leaf(rng: np.random.Generator, kind: int):
    import ml_dtypes

    shape = tuple(int(n) for n in rng.integers(0, 5, int(rng.integers(0, 4))))
    return [lambda: rng.standard_normal(shape).astype(np.float32),
            lambda: rng.standard_normal(shape).astype(ml_dtypes.bfloat16),
            lambda: rng.integers(-2 ** 40, 2 ** 40, shape),
            lambda: rng.integers(-100, 100, shape).astype(np.int8),
            lambda: rng.integers(0, 2, shape).astype(bool),
            lambda: np.float32(rng.standard_normal()),
            lambda: np.int64(rng.integers(-2 ** 62, 2 ** 62)),
            lambda: ml_dtypes.bfloat16(rng.standard_normal()),
            lambda: int(rng.integers(-2 ** 63, 2 ** 63)) >> int(rng.integers(0, 63)),
            lambda: float(rng.standard_normal() * 1e30),
            lambda: [None, True, False][int(rng.integers(0, 3))],
            lambda: "s" * int(rng.choice([0, 31, 32, 300]))][kind]()


def _tree(rng: np.random.Generator, depth: int = 0):
    n = int(rng.choice([0, 1, 3, 15, 16, 20])) if depth else 24
    if depth < 3 and rng.random() < 0.3:
        items = [_tree(rng, depth + 1) for _ in range(n)]
        return items if rng.random() < 0.5 else tuple(items)
    if depth < 3 and rng.random() < 0.5:
        return {f"k{i}_{int(rng.integers(0, 100))}": _tree(rng, depth + 1) for i in range(n)}
    return _leaf(rng, int(rng.integers(0, 12)))


def _expected(x):
    """What the reader gives back: lists and tuples as index maps, bf16 as float32."""
    if isinstance(x, (list, tuple)):
        x = {str(i): v for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: _expected(v) for k, v in x.items()}
    if isinstance(x, (np.ndarray, np.generic)) and x.dtype.name == "bfloat16":
        return np.asarray(x, np.float32) if isinstance(x, np.ndarray) else np.float32(x)
    return x


def _assert_read_back(got, want) -> None:
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_read_back(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and _bits_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", range(4))
def test_packb_equals_flax_to_bytes(seed):
    from quickvc_tpu_torch.utils.msgpack_params import packb, unpackb

    rng = np.random.default_rng(seed)
    tree = {f"top{i}": _tree(rng, 1) for i in range(24)}
    tree["nested"] = {"b": {"z": np.ones(3, np.float32), "a": [np.int32(7), (1, 2.5)]}}
    data = packb(tree)
    assert data == flax.serialization.to_bytes(tree)
    _assert_read_back(unpackb(data), _expected(tree))


def test_chunked_leaves_equal_flax(monkeypatch):
    """Both chunk limits lowered to 40 bytes: a float32 leaf of 420 bytes in
    11 chunks, a bf16 one in 2, a top-level array, small leaves whole."""
    import ml_dtypes

    from quickvc_tpu_torch.utils import msgpack_params

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 40)
    monkeypatch.setattr(msgpack_params, "MAX_CHUNK_SIZE", 40)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((5, 7, 3)).astype(np.float32)
    h = rng.standard_normal((3, 9)).astype(ml_dtypes.bfloat16)
    tree = {"layer": {"w": w, "b": np.ones(4, np.float32), "h": h}, "s": np.float64(2.0)}
    data = msgpack_params.packb(tree)
    assert data == flax.serialization.to_bytes(tree)
    out = msgpack_params.unpackb(data)
    assert _bits_equal(out["layer"]["w"], w)
    assert _bits_equal(out["layer"]["b"], np.ones(4, np.float32))
    assert _bits_equal(out["layer"]["h"], h.astype(np.float32))
    top = rng.standard_normal(30).astype(np.float32)
    assert msgpack_params.packb(top) == flax.serialization.to_bytes(top)


def test_sorted_tree_is_jax_tree_order():
    import jax

    from quickvc_tpu_torch.utils.msgpack_params import sorted_tree

    tree = {"b": {"z": np.ones(1), "10": np.ones(1), "2": {"y": np.ones(1), "x": np.ones(1)}},
            "a": np.ones(1)}
    want = jax.device_get(tree)
    got = sorted_tree(tree)
    assert list(got) == list(want) and list(got["b"]) == list(want["b"])
    assert list(got["b"]["2"]) == list(want["b"]["2"])


@pytest.mark.parametrize("decoder", ["ms", "mb", "istft"])
def test_generator_params_match_port_generator(decoder):
    """The port's state dict -> the JAX tree equals ``port_generator`` of the
    same weights leaf for leaf, bit for bit, key order included (the last
    WaveNet layer's unused res half v = 0, g = 1, bias = 0; no decoder
    buffer); mapped back it gives the state dict again."""
    from quickvc_tpu.config import ModelConfig as JaxModelConfig
    from quickvc_tpu.utils.torch_port import port_generator
    from quickvc_tpu_torch.utils.weights import (generator_params_from_state_dict,
                                                 generator_state_dict_from_jax)

    _, _, port = tiny_generator(seed=12, decoder=decoder)
    sd = port.state_dict()
    jmc = JaxModelConfig(**dict(TINY_MODEL, **DECODER_FLAGS[decoder]))
    golden = port_generator({k: v.numpy() for k, v in sd.items()}, jmc)
    ours = generator_params_from_state_dict(sd, port.model_cfg)
    _same_tree(ours, golden)
    h = TINY_MODEL["hidden_channels"]
    last = ours["enc_q"]["enc"]["layers"]["res_skip"]
    assert not last["v"][-1][..., :h].any() and (last["g"][-1][:h] == 1).all()
    back = generator_state_dict_from_jax(ours, port.model_cfg)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_hubert_params_match_port_hubert():
    """A full-width two-layer bshall state dict (a ``module.`` prefix and a
    training-only entry included) -> the JAX tree equals ``port_hubert``;
    a key off the contract is refused."""
    from quickvc_tpu.utils.hubert_port import port_hubert
    from quickvc_tpu_torch.utils.weights import (expected_hubert_sd_shapes,
                                                 hubert_params_from_state_dict)

    rng = np.random.default_rng(2)
    sd = {f"module.{k}": rng.standard_normal(s, dtype=np.float32)
          for k, s in expected_hubert_sd_shapes(num_layers=2).items()}
    sd["masked_spec_embed"] = rng.standard_normal(768, dtype=np.float32)
    golden = port_hubert(sd, num_layers=2)
    ours = hubert_params_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                         num_layers=2)
    _same_tree(ours, golden)
    sd.pop("module.proj.bias")
    with pytest.raises(ValueError, match="proj.bias"):
        hubert_params_from_state_dict(sd, num_layers=2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of the port's trainer on the CPU at the tiny config; the JAX
    config of the same values."""
    from test_torch_train_data import write_corpus
    from torch_train_support import configs

    from quickvc_tpu_torch.config import config_from_dict
    from quickvc_tpu_torch.train import loop

    tmp = tmp_path_factory.mktemp("export")
    jcfg, cfg = configs(eval_interval=0)
    d = cfg.to_dict()
    d["data"]["training_files"] = d["data"]["validation_files"] = write_corpus(
        tmp / "corpus", np.random.default_rng(4), [0.9, 0.95, 1.0, 0.85])
    hpfile = tmp / "tiny.json"
    config_from_dict(d).save(str(hpfile))
    loop.main(["-c", str(hpfile), "-m", "run", "-mr", str(tmp / "logs"), "--device", "cpu",
               "--max-steps", "2"])
    return tmp, tmp / "logs" / "run", jcfg


def _model(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


def test_cli_msgpack_equals_jax_export_and_converts(trained, capsys, monkeypatch):
    """The ``.msgpack`` bytes; the root loader reads them (against the G
    parameter template its ``create_train_state`` gives, built here without
    the discriminator and optimizers, which it does not read)."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from convert import load_generator_params
    from quickvc_tpu.train import state as jax_state
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
    from quickvc_tpu.train.state import build_models
    from quickvc_tpu.utils.torch_port import port_generator, to_jax
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.scripts import export_params
    from quickvc_tpu_torch.utils.weights import load_generator

    tmp, run_dir, jcfg = trained
    out = export_params.main(["--model-dir", str(run_dir), "--out", str(tmp / "g.msgpack")])
    assert out["step"] == 2 and "after 2 updates" in capsys.readouterr().out
    sd = {k: v.numpy() for k, v in _model(run_dir / "G_2.pth").items()}
    golden = flax.serialization.to_bytes(to_jax(port_generator(sd, jcfg.model)))
    assert (tmp / "g.msgpack").read_bytes() == golden

    net_g, _ = build_models(jcfg)

    def g_template(cfg, rng):   # create_train_state's g_params, without D and optimizers
        f = 32
        shapes = jax.eval_shape(lambda: net_g.init(
            {"params": rng, "sample": rng, "slice": rng},
            jnp.zeros((1, f, cfg.model.unit_channels)), jnp.zeros((1, f, cfg.spec_channels)),
            jnp.zeros((1, f, cfg.data.n_mel_channels))))
        zeros = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes["params"])
        return SimpleNamespace(g_params=zeros), net_g, None

    monkeypatch.setattr(jax_state, "create_train_state", g_template)
    params = load_generator_params(str(tmp / "g.msgpack"), jcfg)
    rng = np.random.default_rng(3)
    unit = rng.standard_normal((2, 30, jcfg.model.unit_channels)).astype(np.float32)
    g = rng.standard_normal((2, jcfg.model.gin_channels)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    infer = jax.jit(lambda p, u, gv: net_g.apply({"params": p}, u, gv, 0.0,
                                                  method=JaxSynth.infer))
    ref = np.asarray(infer(params, jnp.asarray(unit), jnp.asarray(g)))[..., 0]
    cfg = load_config(str(run_dir / "config.json"))
    port = SynthesizerTrn(cfg.spec_channels, cfg.segment_frames, cfg.model)
    load_generator(str(run_dir / "G_2.pth"), port)
    with torch.no_grad():
        ours = port.eval().infer(torch.from_numpy(unit.transpose(0, 2, 1).copy()),
                                 torch.from_numpy(g), noise_scale=0.0)[:, 0].numpy()
    assert ours.shape == ref.shape == (2, 30 * 320)
    assert np.abs(ours - ref).max() <= 1e-3 * np.abs(ref).max()


def test_cli_torch_format_equals_jax_export(trained):
    from quickvc_tpu.utils.torch_export import (export_discriminator, export_generator,
                                                save_reference_checkpoint)
    from quickvc_tpu.utils.torch_port import port_discriminator, port_generator
    from quickvc_tpu_torch.config import load_config
    from quickvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.scripts import export_params
    from quickvc_tpu_torch.utils.weights import load_discriminator, load_generator

    tmp, run_dir, jcfg = trained
    export_params.main(["--model-dir", str(run_dir), "--format", "torch", "--out",
                        str(tmp / "G.pth"), "--disc-out", str(tmp / "D.pth")])
    g_sd = {k: v.numpy() for k, v in _model(run_dir / "G_2.pth").items()}
    d_sd = {k: v.numpy() for k, v in _model(run_dir / "D_2.pth").items()}
    lr = jcfg.train.learning_rate
    save_reference_checkpoint(str(tmp / "G_jax.pth"), export_generator(
        port_generator(g_sd, jcfg.model), jcfg.model), 2, lr)
    save_reference_checkpoint(str(tmp / "D_jax.pth"), export_discriminator(
        port_discriminator(d_sd)), 2, lr)
    for kind in "GD":
        ours, theirs = (torch.load(tmp / f"{kind}{s}.pth", weights_only=True)
                        for s in ("", "_jax"))
        assert ours.keys() == theirs.keys()
        assert {k: ours[k] for k in ours if k != "model"} == {
            "iteration": 2, "optimizer": None, "learning_rate": lr}
        assert ours["model"].keys() == theirs["model"].keys()
        assert all(torch.equal(v, theirs["model"][k]) for k, v in ours["model"].items())
    assert "dec.updown_filter" in _model(run_dir / "G_2.pth")   # a buffer, not exported
    assert "dec.updown_filter" not in torch.load(tmp / "G.pth", weights_only=True)["model"]
    cfg = load_config(str(run_dir / "config.json"))
    load_generator(str(tmp / "G.pth"), SynthesizerTrn(cfg.spec_channels, cfg.segment_frames,
                                                      cfg.model))
    load_discriminator(str(tmp / "D.pth"), MultiPeriodDiscriminator(width=cfg.train.disc_width))


def test_cli_hubert_equals_jax_export(tmp_path, monkeypatch):
    """A bshall checkpoint of twelve layers at the tiny widths (the key
    contract patched to them) through ``--hubert-in/--hubert-out``: the bytes
    the JAX exporter writes for it."""
    import jax

    from quickvc_tpu.utils.hubert_port import port_hubert
    from quickvc_tpu.utils.torch_port import to_jax
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.scripts import export_params
    from quickvc_tpu_torch.utils import weights

    h = dict(TINY_HUBERT, num_layers=12)
    monkeypatch.setattr(weights, "expected_hubert_sd_shapes", functools.partial(
        weights.expected_hubert_sd_shapes, embed_dim=h["embed_dim"], ffn_dim=h["ffn_dim"],
        unit_dim=h["unit_dim"], conv_dim=h["extractor_channels"],
        pos_kernel=h["pos_kernel_size"], pos_groups=h["pos_groups"]))
    hub = weights.init_random_(HubertSoft(**h), 5)
    torch.save({"hubert": hub.state_dict()}, tmp_path / "hubert-soft.pt")
    out = export_params.main(["--hubert-in", str(tmp_path / "hubert-soft.pt"),
                              "--hubert-out", str(tmp_path / "h.msgpack")])
    assert out == {"hubert": str(tmp_path / "h.msgpack")}
    sd = {k: v.numpy() for k, v in hub.state_dict().items()}
    golden = flax.serialization.to_bytes(jax.device_get(to_jax(port_hubert(sd))))
    assert (tmp_path / "h.msgpack").read_bytes() == golden
