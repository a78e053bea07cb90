"""PyTorch port, the JAX package's ``.msgpack`` parameter files
(``scripts/export_params.py`` writes them with ``flax.serialization.to_bytes``).

The port's pure-Python decoder (``quickvc_tpu_torch/utils/msgpack_params.py``)
against ``msgpack.unpackb`` on seeded random structures and against flax's
own layout (ndarray and numpy-scalar ext values, chunked leaves, bf16); its
refusals; the generator of each decoder and a tiny HuBERT through
``flax.serialization.to_bytes`` -> the port's state dicts bit-equal to the
mappings of the same trees; and the conversion and encoding CLIs taking
``.msgpack`` files, their outputs equal to the ``.pth``/``.pt`` routes'.
"""

import functools

import msgpack
import numpy as np
import pytest
import torch

import flax.serialization

from torch_port_support import TINY_HUBERT, TINY_MODEL, tiny_generator, tiny_hubert


def _to_bytes(tree) -> bytes:
    return flax.serialization.to_bytes(tree)


def _random_value(rng: np.random.Generator, depth: int):
    kind = rng.integers(0, 9 if depth < 3 else 6)
    if kind == 0:
        return [None, True, False][rng.integers(0, 3)]
    if kind == 1:   # every integer width, both signs
        bits = int(rng.integers(1, 64))
        v = int(rng.integers(0, 2 ** bits - 1, dtype=np.uint64))
        return -v if rng.integers(0, 2) and v < 2 ** 63 else v
    if kind == 2:
        return float(rng.standard_normal() * 10.0 ** rng.integers(-30, 30))
    if kind == 3:   # fixstr, str8, str16
        n = int(rng.choice([0, 5, 31, 32, 200, 300, 70000]))
        return "".join(chr(c) for c in rng.integers(32, 0x3000, n))
    if kind == 4:   # bin8, bin16, bin32
        return rng.bytes(int(rng.choice([0, 3, 255, 256, 70000])))
    if kind == 5:
        return int(rng.integers(-32, 128))   # fixints
    n = int(rng.choice([0, 3, 15, 16, 40] if depth == 0 else [0, 3, 15, 16]))
    if kind == 6:
        return [_random_value(rng, depth + 1) for _ in range(n)]
    return {f"k{i}_{rng.integers(0, 1000)}": _random_value(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(6))
def test_unpackb_matches_msgpack(seed):
    from quickvc_tpu_torch.utils.msgpack_params import unpackb

    rng = np.random.default_rng(seed)
    value = {f"top{i}": _random_value(rng, 0) for i in range(20)}
    value["big_list"] = list(range(70000))
    value["big_map"] = {str(i): i for i in range(70000)}
    for single_float in (False, True):
        data = msgpack.packb(value, use_bin_type=True, use_single_float=single_float)
        assert unpackb(data) == msgpack.unpackb(data, raw=False)


def test_flax_layout_leaves():
    """ndarray and numpy-scalar ext values of every accepted dtype, a bf16
    leaf (widened to float32), and a leaf flax splits into chunks."""
    import ml_dtypes

    from quickvc_tpu_torch.utils.msgpack_params import unpackb

    rng = np.random.default_rng(0)
    tree = {"f32": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "f16": rng.standard_normal(7).astype(np.float16),
            "f64": rng.standard_normal((2, 2)),
            "i8": rng.integers(-100, 100, 9).astype(np.int8),
            "u32": rng.integers(0, 2 ** 31, 4).astype(np.uint32),
            "i64": rng.integers(-2 ** 40, 2 ** 40, 3),
            "bool": rng.integers(0, 2, 5).astype(bool),
            "empty": np.zeros((0, 3), np.float32),
            "scalar": {"a": np.float32(2.5), "b": np.int32(-7)}}
    out = unpackb(_to_bytes(tree))
    for k, v in tree.items():
        if k == "scalar":
            assert out[k] == v and all(type(out[k][s]) is type(v[s]) for s in v)
        else:
            assert out[k].dtype == v.dtype and out[k].shape == v.shape
            np.testing.assert_array_equal(out[k], v)
            assert out[k].flags.writeable
    bf16 = rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)
    out = unpackb(_to_bytes({"w": bf16}))["w"]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, bf16.astype(np.float32))


def test_chunked_leaf(monkeypatch):
    from quickvc_tpu_torch.utils.msgpack_params import unpackb

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 40)
    w = np.random.default_rng(1).standard_normal((5, 7, 3)).astype(np.float32)
    data = _to_bytes({"layer": {"w": w, "b": np.ones(4, np.float32)}})
    raw = msgpack.unpackb(data, raw=False, ext_hook=lambda c, d: msgpack.ExtType(c, d))
    assert raw["layer"]["w"]["__msgpack_chunked_array__"] is True   # flax chunked it
    assert len(raw["layer"]["w"]["chunks"]) == 11
    out = unpackb(data)
    np.testing.assert_array_equal(out["layer"]["w"], w)
    np.testing.assert_array_equal(out["layer"]["b"], np.ones(4, np.float32))


def test_refusals():
    from quickvc_tpu_torch.utils.msgpack_params import MsgpackFormatError, unpackb

    with pytest.raises(MsgpackFormatError, match="ext type 5"):
        unpackb(msgpack.packb({"a": msgpack.ExtType(5, b"xyz")}))
    with pytest.raises(MsgpackFormatError, match="ext type 2"):
        unpackb(_to_bytes({"c": 1 + 2j}))                      # flax's native complex
    with pytest.raises(MsgpackFormatError, match="complex64"):
        unpackb(_to_bytes({"z": np.zeros(3, np.complex64)}))
    with pytest.raises(MsgpackFormatError, match="type byte 0xc1"):
        unpackb(b"\xc1")
    with pytest.raises(MsgpackFormatError, match="truncated"):
        unpackb(msgpack.packb({"abc": "defgh"})[:-2])
    with pytest.raises(MsgpackFormatError, match="after the value"):
        unpackb(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize("decoder", ["ms", "mb", "istft"])
def test_generator_msgpack_loads_bit_equal(tmp_path, decoder):
    """``to_bytes`` of the JAX generator's params -> the port's decoded tree,
    mapped, equals the mapping of the tree itself; ``load_generator`` takes
    the file into a model on the meta device, strictly."""
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.msgpack_params import load_params
    from quickvc_tpu_torch.utils.weights import generator_state_dict_from_jax, load_generator

    _, params, port = tiny_generator(seed=4, decoder=decoder)
    path = tmp_path / "g.msgpack"
    path.write_bytes(_to_bytes(params))
    mc = port.model_cfg
    golden = generator_state_dict_from_jax(params, mc)
    ours = generator_state_dict_from_jax(load_params(str(path)), mc)
    assert ours.keys() == golden.keys()
    for k in golden:
        assert ours[k].dtype == golden[k].dtype and torch.equal(ours[k], golden[k]), k
    with torch.device("meta"):
        fresh = SynthesizerTrn(33, 8, mc)
    load_generator(str(path), fresh)
    expected = port.state_dict()
    assert fresh.state_dict().keys() == expected.keys()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, expected[k]), k


def test_hubert_msgpack_loads_bit_equal(tmp_path, monkeypatch):
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.utils import weights
    from quickvc_tpu_torch.utils.msgpack_params import load_params

    _, params, port = tiny_hubert("faststats", seed=5)
    path = tmp_path / "hubert.msgpack"
    path.write_bytes(_to_bytes(params))
    golden = weights.hubert_state_dict_from_jax(params)
    ours = weights.hubert_state_dict_from_jax(load_params(str(path)))
    assert ours.keys() == golden.keys()
    assert all(torch.equal(ours[k], golden[k]) for k in golden)
    h = TINY_HUBERT   # the bshall contract at the tiny widths
    monkeypatch.setattr(weights, "expected_hubert_sd_shapes", functools.partial(
        weights.expected_hubert_sd_shapes, embed_dim=h["embed_dim"], ffn_dim=h["ffn_dim"],
        unit_dim=h["unit_dim"], conv_dim=h["extractor_channels"],
        pos_kernel=h["pos_kernel_size"], pos_groups=h["pos_groups"]))
    with torch.device("meta"):
        fresh = HubertSoft(**h)
    weights.load_hubert(str(path), fresh)
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in fresh.state_dict().items())


def test_convert_and_encode_take_msgpack(tmp_path, rng, monkeypatch):
    """The conversion CLI with a multiband G as ``.msgpack``, batch and
    ``--streaming``, writes what it writes from the same G as ``.pth``; the
    encoding CLI with a HuBERT as ``.msgpack`` what it writes from the ``.pt``."""
    from quickvc_tpu_torch import convert, encode
    from quickvc_tpu_torch.config import ModelConfig, QuickVCConfig
    from quickvc_tpu_torch.data.audio_io import read_wav, write_wav
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.utils import weights

    _, params, port = tiny_generator(seed=6, decoder="mb", spec_channels=641)
    jnet_h, h_params, hub = tiny_hubert("faststats", seed=7)
    h = TINY_HUBERT
    monkeypatch.setattr(convert, "HubertSoft", functools.partial(HubertSoft, **h))
    monkeypatch.setattr(encode, "HubertSoft", functools.partial(HubertSoft, **h))
    monkeypatch.setattr(weights, "expected_hubert_sd_shapes", functools.partial(
        weights.expected_hubert_sd_shapes, embed_dim=h["embed_dim"], ffn_dim=h["ffn_dim"],
        unit_dim=h["unit_dim"], conv_dim=h["extractor_channels"],
        pos_kernel=h["pos_kernel_size"], pos_groups=h["pos_groups"]))
    files = {"g.msgpack": _to_bytes(params), "hubert.msgpack": _to_bytes(h_params)}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    torch.save({"model": port.state_dict()}, tmp_path / "G.pth")
    torch.save({"hubert": hub.state_dict()}, tmp_path / "hubert.pt")
    cfg = QuickVCConfig(model=ModelConfig(**dict(
        TINY_MODEL, unit_channels=h["unit_dim"], ms_istft_vits=False, mb_istft_vits=True)))
    hpfile = str(tmp_path / "config.json")
    cfg.save(hpfile)
    src, tgt = tmp_path / "wavs" / "src.wav", tmp_path / "wavs" / "tgt.wav"
    src.parent.mkdir()
    write_wav(str(src), (rng.standard_normal(30400 + 50) * 0.2).astype(np.float32), 16000)
    write_wav(str(tgt), (rng.standard_normal(16000) * 0.2).astype(np.float32), 16000)
    txt = tmp_path / "convert.txt"
    txt.write_text(f"pair0|{src}|{tgt}\n")
    waves = {}
    for g, hb in (("G.pth", "hubert.pt"), ("g.msgpack", "hubert.msgpack")):
        for extra in ([], ["--streaming"]):
            out = tmp_path / f"{g}{len(extra)}"
            convert.main(["--device", "cpu", "--hpfile", hpfile, "--ptfile",
                          str(tmp_path / g), "--hubert", str(tmp_path / hb), "--txtpath",
                          str(txt), "--outdir", str(out), "--noise-scale", "0",
                          "--host-workers", "1", *extra])
            waves[g, len(extra)], _ = read_wav(str(out / "pair0.wav"))
    for streaming in (0, 1):
        a, b = waves["G.pth", streaming], waves["g.msgpack", streaming]
        assert len(a) == 95 * 320 and np.array_equal(a, b) and np.abs(a).max() > 0
    units = {}
    for hb in ("hubert.pt", "hubert.msgpack"):
        encode.main(["soft", str(src.parent), str(tmp_path / f"units_{hb}"), "--hubert",
                     str(tmp_path / hb), "--device", "cpu", "--batch", "2"])
        units[hb] = np.load(tmp_path / f"units_{hb}" / "src.npy")
    np.testing.assert_array_equal(units["hubert.pt"], units["hubert.msgpack"])


def test_trainer_warm_starts_from_msgpack(tmp_path):
    """``--init-from-torch`` takes the JAX package's G ``.msgpack`` (the
    multiband model here): its weights exactly, step 0 (the file holds none)."""
    from torch_train_support import TINY, configs

    from quickvc_tpu_torch.train import loop

    model = dict(TINY["model"], ms_istft_vits=False, mb_istft_vits=True)
    _, params, port = tiny_generator(seed=10, spec_channels=641, **model)
    path = tmp_path / "g.msgpack"
    path.write_bytes(_to_bytes(params))
    _, cfg = configs(model)
    cfg.model_dir = str(tmp_path / "warm")
    state = loop._initial_state(cfg, torch.device("cpu"), (str(path), None),
                                loop.get_logger(cfg.model_dir))
    assert state.step == 0 and state.cfg.model.decoder_kind == "mb_istft"
    sd = state.net_g.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in port.state_dict().items())
