"""Carrying weights into the port: JAX trees and ``.msgpack``, reference ``.pth``, bshall ``.pt``.

- :func:`generator_state_dict_from_jax` and
  :func:`discriminator_state_dict_from_jax` are the port's own copies of the
  mappings in ``quickvc_tpu/utils/torch_export.py:44-152`` (flax params ->
  reference ``SynthesizerTrn`` / ``MultiPeriodDiscriminator`` state dicts).
- :func:`disc_variant_state_dict_from_jax` maps the variants of
  ``scripts/disc_pallas_ab.py`` onto the port's A/B script.
- :func:`hubert_state_dict_from_jax` inverts ``quickvc_tpu/utils/hubert_port.py:port_hubert``.
- :func:`generator_params_from_state_dict` and
  :func:`hubert_params_from_state_dict` are the port's own copies of the
  JAX package's ports the other way (``quickvc_tpu/utils/torch_port.py:port_generator``,
  ``quickvc_tpu/utils/hubert_port.py:port_hubert``): the port's state dicts
  -> flax parameter trees of numpy arrays, which
  ``quickvc_tpu_torch/scripts/export_params.py`` writes as ``.msgpack``.
- :func:`load_generator` / :func:`load_discriminator` / :func:`load_hubert`
  read checkpoints (G and HuBERT also as the JAX package's ``.msgpack``
  parameter files) and load them with ``strict=True``.
- :func:`init_random_` gives a module seeded random weights.

Layouts: flax ``kernel``/``v`` (k, in, out) <-> torch Conv1d ``weight`` (out,
in, k); flax ConvTranspose ``v`` (k, out, in) <-> torch (in, out, k); flax
``g`` (c,) <-> torch ``weight_g`` (c, 1, 1); flax Dense ``kernel`` (in, out)
<-> torch Linear ``weight`` (out, in). LSTM weights map 1:1 (gate order
i, f, g, o).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from quickvc_tpu_torch.utils.msgpack_params import load_params

# --------------------------------------------------------------------------
# JAX generator params -> reference SynthesizerTrn state dict


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _conv_w(v) -> np.ndarray:
    return _np(v).transpose(2, 1, 0)  # (k, in, out) -> (out, in, k)


def _wn_conv(dst: dict, prefix: str, p: Mapping[str, Any], transpose=None,
             g_rank: int = 3) -> None:
    v = _np(p["v"])
    dst[f"{prefix}.weight_v"] = v.transpose(*transpose) if transpose else _conv_w(v)
    dst[f"{prefix}.weight_g"] = _np(p["g"]).reshape((-1,) + (1,) * (g_rank - 1))
    if "bias" in p:
        dst[f"{prefix}.bias"] = _np(p["bias"])


def _plain_conv(dst: dict, prefix: str, p: Mapping[str, Any]) -> None:
    dst[f"{prefix}.weight"] = _conv_w(p["kernel"])
    if "bias" in p:
        dst[f"{prefix}.bias"] = _np(p["bias"])


def _wavenet(dst: dict, prefix: str, p: Mapping[str, Any]) -> None:
    """Scan-stacked layers (leading layer axis) -> per-layer convs.

    The JAX stack keeps the last res/skip conv 2h wide with an unused res
    half; the reference's last layer is h wide (skip only).
    """
    if "cond_layer" in p:
        _wn_conv(dst, f"{prefix}.cond_layer", p["cond_layer"])
    ins, rss = p["layers"]["in"], p["layers"]["res_skip"]
    n_layers = ins["v"].shape[0]
    h = ins["v"].shape[2]
    for i in range(n_layers):
        _wn_conv(dst, f"{prefix}.in_layers.{i}", {k: ins[k][i] for k in ins})
        r = {k: rss[k][i] for k in rss}
        if i == n_layers - 1:
            r = {"v": r["v"][..., h:], "g": r["g"][h:], "bias": r["bias"][h:]}
        _wn_conv(dst, f"{prefix}.res_skip_layers.{i}", r)


def _cond_normal(dst: dict, prefix: str, p: Mapping[str, Any]) -> None:
    _plain_conv(dst, f"{prefix}.pre", p["pre"])
    _wavenet(dst, f"{prefix}.enc", p["enc"])
    _plain_conv(dst, f"{prefix}.proj", p["proj"])


def _updown_filter(subbands: int) -> np.ndarray:
    f = np.zeros((subbands, subbands, subbands), np.float32)
    for k in range(subbands):
        f[k, k, 0] = 1.0
    return f


def _tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    # C-order copies: np.array keeps a transposed view's order, and a CPU
    # convolution's sums depend on its weight's strides, so a mapped tree gave
    # outputs a float32 ulp away from the same weights loaded from a .pth
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}


def generator_state_dict_from_jax(params: Mapping[str, Any], model_cfg) -> dict[str, torch.Tensor]:
    """flax ``SynthesizerTrn`` params (numpy leaves) -> the port's state dict,
    for each decoder (``quickvc_tpu/utils/torch_export.py:127-133``):
    ``dec.conv_post`` for ``istft``, ``dec.subband_conv_post`` for both
    sub-band decoders, and for ``ms_istft`` also ``dec.multistream_conv_post``
    and its constant ``dec.updown_filter``."""
    sd: dict[str, np.ndarray] = {}
    _cond_normal(sd, "enc_q", params["enc_q"])
    _cond_normal(sd, "enc_p", params["enc_p"])
    for i in range(model_cfg.n_flows):
        ours = params["flow"][f"flow_{i}"]
        tp = f"flow.flows.{2 * i}"  # couplings interleave with Flips
        _plain_conv(sd, f"{tp}.pre", ours["pre"])
        _wavenet(sd, f"{tp}.enc", ours["enc"])
        _plain_conv(sd, f"{tp}.post", ours["post"])

    lstm = params["enc_spk"]["lstm"]
    for layer in range(3):
        for theirs, ours in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                             ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
            sd[f"enc_spk.lstm.{theirs}_l{layer}"] = _np(lstm[f"{ours}_l{layer}"])
    sd["enc_spk.linear.weight"] = _np(params["enc_spk"]["linear"]["kernel"]).T
    sd["enc_spk.linear.bias"] = _np(params["enc_spk"]["linear"]["bias"])

    dec, backbone = params["dec"], params["dec"]["backbone"]
    _wn_conv(sd, "dec.conv_pre", backbone["conv_pre"])
    _plain_conv(sd, "dec.cond", backbone["cond"])
    nk = len(model_cfg.resblock_kernel_sizes)
    for i in range(len(model_cfg.upsample_rates)):
        _wn_conv(sd, f"dec.ups.{i}", backbone[f"up_{i}"], transpose=(2, 1, 0))
        for j in range(nk):
            rb = backbone[f"resblock_{i}_{j}"]
            rp = f"dec.resblocks.{i * nk + j}"
            for m in range(len(model_cfg.resblock_dilation_sizes[j])):
                _wn_conv(sd, f"{rp}.convs1.{m}", rb[f"conv1_{m}"])
                _wn_conv(sd, f"{rp}.convs2.{m}", rb[f"conv2_{m}"])
    if model_cfg.decoder_kind == "istft":
        _wn_conv(sd, "dec.conv_post", dec["conv_post"])
    else:
        _wn_conv(sd, "dec.subband_conv_post", dec["head"]["subband_conv_post"])
    if model_cfg.decoder_kind == "ms_istft":
        _wn_conv(sd, "dec.multistream_conv_post", dec["multistream_conv_post"])
        sd["dec.updown_filter"] = _updown_filter(model_cfg.subbands)
    return _tensors(sd)


# --------------------------------------------------------------------------
# the port's state dicts -> JAX parameter trees (the export direction)


def _leaf(x) -> np.ndarray:
    """A float32 C-order numpy copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.array(x, np.float32, order="C")


def _jax_conv(sd, prefix: str, weight: str = "weight_v") -> np.ndarray:
    return np.ascontiguousarray(_leaf(sd[f"{prefix}.{weight}"]).transpose(2, 1, 0))


def _jax_wn_conv(sd, prefix: str, bias: bool = True) -> dict:
    out = {"v": _jax_conv(sd, prefix), "g": _leaf(sd[f"{prefix}.weight_g"]).reshape(-1)}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _leaf(sd[f"{prefix}.bias"])
    return out


def _jax_plain_conv(sd, prefix: str) -> dict:
    out = {"kernel": _jax_conv(sd, prefix, "weight")}
    if f"{prefix}.bias" in sd:
        out["bias"] = _leaf(sd[f"{prefix}.bias"])
    return out


def _jax_wavenet(sd, prefix: str, n_layers: int, has_cond: bool) -> dict:
    """Per-layer convs -> the JAX stack (leading layer axis). The JAX stack is
    uniformly 2h wide: the last res/skip layer's h skip channels go to its
    [h, 2h) slot and its unused res half is v = 0, g = 1, bias = 0, as
    ``port_generator`` fills it (``quickvc_tpu/utils/torch_port.py:93-130``)."""
    out: dict = {}
    if has_cond:
        out["cond_layer"] = _jax_wn_conv(sd, f"{prefix}.cond_layer")
    ins = {"v": [], "g": [], "bias": []}
    rss = {"v": [], "g": [], "bias": []}
    for i in range(n_layers):
        c = _jax_wn_conv(sd, f"{prefix}.in_layers.{i}")
        h = c["v"].shape[1]
        r = _jax_wn_conv(sd, f"{prefix}.res_skip_layers.{i}")
        if r["v"].shape[-1] == h:
            v = np.zeros(r["v"].shape[:-1] + (2 * h,), np.float32)
            v[..., h:] = r["v"]
            g = np.ones(2 * h, np.float32)
            g[h:] = r["g"]
            bias = np.zeros(2 * h, np.float32)
            bias[h:] = r["bias"]
            r = {"v": v, "g": g, "bias": bias}
        for k in ins:
            ins[k].append(c[k])
            rss[k].append(r[k])
    out["layers"] = {"in": {k: np.stack(v) for k, v in ins.items()},
                     "res_skip": {k: np.stack(v) for k, v in rss.items()}}
    return out


def generator_params_from_state_dict(sd: Mapping[str, Any], model_cfg) -> dict:
    """The port's (or the reference's) ``SynthesizerTrn`` state dict -> the
    JAX generator's parameter tree of float32 numpy arrays, in the key order
    ``quickvc_tpu/utils/torch_port.py:port_generator`` builds, for each
    decoder. The constant buffers (``dec.updown_filter``, a reference
    checkpoint's ``dec.*stft.window`` and ``dec.pqmf.*``) have no JAX
    parameter and are left out."""
    nk = len(model_cfg.resblock_kernel_sizes)
    flow = {}
    for i in range(model_cfg.n_flows):
        tp = f"flow.flows.{2 * i}"   # couplings interleave with Flips
        flow[f"flow_{i}"] = {"pre": _jax_plain_conv(sd, f"{tp}.pre"),
                             "enc": _jax_wavenet(sd, f"{tp}.enc", model_cfg.flow_wn_layers, True),
                             "post": _jax_plain_conv(sd, f"{tp}.post")}
    lstm = {}
    for layer in range(3):
        for nm in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            ours = nm.replace("weight", "w").replace("bias", "b")
            lstm[f"{ours}_l{layer}"] = _leaf(sd[f"enc_spk.lstm.{nm}_l{layer}"])
    backbone = {"conv_pre": _jax_wn_conv(sd, "dec.conv_pre"),
                "cond": _jax_plain_conv(sd, "dec.cond")}
    for i in range(len(model_cfg.upsample_rates)):
        # ConvTranspose1d: torch (in, out, k) -> JAX (k, out, in), the same transpose
        backbone[f"up_{i}"] = _jax_wn_conv(sd, f"dec.ups.{i}")
        for j in range(nk):
            rp = f"dec.resblocks.{i * nk + j}"
            rb = {}
            for m in range(len(model_cfg.resblock_dilation_sizes[j])):
                rb[f"conv1_{m}"] = _jax_wn_conv(sd, f"{rp}.convs1.{m}")
                rb[f"conv2_{m}"] = _jax_wn_conv(sd, f"{rp}.convs2.{m}")
            backbone[f"resblock_{i}_{j}"] = rb
    dec: dict[str, Any] = {"backbone": backbone}
    if model_cfg.decoder_kind == "istft":
        dec["conv_post"] = _jax_wn_conv(sd, "dec.conv_post")
    else:
        dec["head"] = {"subband_conv_post": _jax_wn_conv(sd, "dec.subband_conv_post")}
        if model_cfg.decoder_kind == "ms_istft":
            dec["multistream_conv_post"] = _jax_wn_conv(sd, "dec.multistream_conv_post",
                                                        bias=False)
    enc = model_cfg.enc_wn_layers
    return {"enc_q": {"pre": _jax_plain_conv(sd, "enc_q.pre"),
                      "enc": _jax_wavenet(sd, "enc_q.enc", enc, True),
                      "proj": _jax_plain_conv(sd, "enc_q.proj")},
            "enc_p": {"pre": _jax_plain_conv(sd, "enc_p.pre"),
                      "enc": _jax_wavenet(sd, "enc_p.enc", enc, False),
                      "proj": _jax_plain_conv(sd, "enc_p.proj")},
            "flow": flow,
            "enc_spk": {"lstm": lstm,
                        "linear": {"kernel": np.ascontiguousarray(
                                       _leaf(sd["enc_spk.linear.weight"]).T),
                                   "bias": _leaf(sd["enc_spk.linear.bias"])}},
            "dec": dec}


def discriminator_state_dict_from_jax(params: Mapping[str, Any],
                                      periods=(2, 3, 5, 7, 11)) -> dict[str, torch.Tensor]:
    """flax ``MultiPeriodDiscriminator`` params (numpy leaves) -> reference
    ``MultiPeriodDiscriminator`` state dict (the port's own copy of
    ``quickvc_tpu/utils/torch_export.py:export_discriminator``). Conv2d
    ``v`` (kh, kw, in, out) -> ``weight_v`` (out, in, kh, kw)."""
    sd: dict[str, np.ndarray] = {}
    s = params["disc_s"]
    for i in range(6):
        _wn_conv(sd, f"discriminators.0.convs.{i}", s[f"WNConv1d_{i}"])
    _wn_conv(sd, "discriminators.0.conv_post", s["WNConv1d_6"])
    for d, period in enumerate(periods, start=1):
        p = params[f"disc_p{period}"]
        for i in range(5):
            _wn_conv(sd, f"discriminators.{d}.convs.{i}", p[f"WNConv2d_{i}"],
                     transpose=(3, 2, 0, 1), g_rank=4)
        _wn_conv(sd, f"discriminators.{d}.conv_post", p["WNConv2d_5"],
                 transpose=(3, 2, 0, 1), g_rank=4)
    return _tensors(sd)


def disc_variant_state_dict_from_jax(params: Mapping[str, Any],
                                     mode: str) -> dict[str, torch.Tensor]:
    """flax ``DiscPVariant`` params of ``scripts/disc_pallas_ab.py`` (numpy
    leaves) -> the state dict of the port's
    ``quickvc_tpu_torch.scripts.disc_pallas_ab.DiscPVariant`` in ``mode``:
    the stack's convs (``WNConv2d_i``, or ``WNConv2dOutScale_i`` for
    ``outscale``) -> ``convs.i``, the fifth conv of ``pallas_l5`` (``l5_v``,
    ``l5_g``, ``l5_bias``) -> ``convs.4``, the last ``WNConv2d`` ->
    ``conv_post``; Conv2d ``v`` (kh, kw, in, out) -> ``weight_v`` (out, in,
    kh, kw)."""
    sd: dict[str, np.ndarray] = {}
    stack = "WNConv2dOutScale" if mode == "outscale" else "WNConv2d"
    convs = [params[f"{stack}_{i}"] for i in range(4 if mode == "pallas_l5" else 5)]
    if mode == "pallas_l5":
        convs.append({"v": params["l5_v"], "g": params["l5_g"], "bias": params["l5_bias"]})
    posts = sum(k.startswith("WNConv2d_") for k in params)
    for i, p in enumerate(convs):
        _wn_conv(sd, f"convs.{i}", p, transpose=(3, 2, 0, 1), g_rank=4)
    _wn_conv(sd, "conv_post", params[f"WNConv2d_{posts - 1}"], transpose=(3, 2, 0, 1),
             g_rank=4)
    return _tensors(sd)


# --------------------------------------------------------------------------
# JAX HuBERT params -> bshall HubertSoft state dict, and its key contract


def hubert_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``HubertSoft`` params -> bshall key layout (inverse of ``port_hubert``)."""
    sd: dict[str, np.ndarray] = {}

    def linear(prefix, p):
        sd[f"{prefix}.weight"] = _np(p["kernel"]).T
        sd[f"{prefix}.bias"] = _np(p["bias"])

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = _np(p["scale"])
        sd[f"{prefix}.bias"] = _np(p["bias"])

    fe = params["feature_extractor"]
    for i in range(7):
        sd[f"feature_extractor.conv{i}.weight"] = _conv_w(fe[f"conv{i}"]["kernel"])
    ln("feature_extractor.norm0", fe["norm0"])
    ln("feature_projection.norm", params["feature_projection"]["norm"])
    linear("feature_projection.projection", params["feature_projection"]["projection"])
    pos = params["positional_embedding"]
    k = pos["g"].shape[0]
    sd["positional_embedding.conv.weight_v"] = _conv_w(pos["v"])
    sd["positional_embedding.conv.weight_g"] = _np(pos["g"]).reshape(1, 1, k)
    sd["positional_embedding.conv.bias"] = _np(pos["bias"])
    ln("norm", params["norm"])
    i = 0
    while f"layer_{i}" in params:
        p, tp = params[f"layer_{i}"], f"encoder.layers.{i}"
        sd[f"{tp}.self_attn.in_proj_weight"] = _np(p["self_attn"]["in_proj_weight"])
        sd[f"{tp}.self_attn.in_proj_bias"] = _np(p["self_attn"]["in_proj_bias"])
        linear(f"{tp}.self_attn.out_proj", p["self_attn"]["out_proj"])
        linear(f"{tp}.linear1", p["linear1"])
        linear(f"{tp}.linear2", p["linear2"])
        ln(f"{tp}.norm1", p["norm1"])
        ln(f"{tp}.norm2", p["norm2"])
        i += 1
    linear("proj", params["proj"])
    return _tensors(sd)


def expected_hubert_sd_shapes(num_layers: int = 12, embed_dim: int = 768,
                              ffn_dim: int = 3072, unit_dim: int = 256,
                              conv_dim: int = 512, pos_kernel: int = 128,
                              pos_groups: int = 16) -> dict[str, tuple]:
    """The bshall/hubert ``HubertSoft`` state-dict contract (HuBERT-Base dims)."""
    exp = {
        "feature_extractor.conv0.weight": (conv_dim, 1, 10),
        "feature_extractor.norm0.weight": (conv_dim,),
        "feature_extractor.norm0.bias": (conv_dim,),
        "feature_projection.norm.weight": (conv_dim,),
        "feature_projection.norm.bias": (conv_dim,),
        "feature_projection.projection.weight": (embed_dim, conv_dim),
        "feature_projection.projection.bias": (embed_dim,),
        "positional_embedding.conv.weight_v": (embed_dim, embed_dim // pos_groups, pos_kernel),
        "positional_embedding.conv.weight_g": (1, 1, pos_kernel),
        "positional_embedding.conv.bias": (embed_dim,),
        "norm.weight": (embed_dim,),
        "norm.bias": (embed_dim,),
        "proj.weight": (unit_dim, embed_dim),
        "proj.bias": (unit_dim,),
    }
    for i in range(1, 5):
        exp[f"feature_extractor.conv{i}.weight"] = (conv_dim, conv_dim, 3)
    for i in range(5, 7):
        exp[f"feature_extractor.conv{i}.weight"] = (conv_dim, conv_dim, 2)
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        exp.update({
            f"{p}.self_attn.in_proj_weight": (3 * embed_dim, embed_dim),
            f"{p}.self_attn.in_proj_bias": (3 * embed_dim,),
            f"{p}.self_attn.out_proj.weight": (embed_dim, embed_dim),
            f"{p}.self_attn.out_proj.bias": (embed_dim,),
            f"{p}.linear1.weight": (ffn_dim, embed_dim),
            f"{p}.linear1.bias": (ffn_dim,),
            f"{p}.linear2.weight": (embed_dim, ffn_dim),
            f"{p}.linear2.bias": (embed_dim,),
            f"{p}.norm1.weight": (embed_dim,),
            f"{p}.norm1.bias": (embed_dim,),
            f"{p}.norm2.weight": (embed_dim,),
            f"{p}.norm2.bias": (embed_dim,),
        })
    return exp


# entries of a real bshall checkpoint that only its training uses
_HUBERT_TRAINING_ONLY = ("masked_spec_embed", "label_embedding")


def validate_hubert_sd(sd: Mapping[str, Any], num_layers: int = 12) -> None:
    """Raise, with the differences, unless ``sd`` keeps the HubertSoft contract."""
    shapes = {k.replace("module.", ""): tuple(v.shape) for k, v in sd.items()}
    ignored = {k for k in shapes if k.split(".")[0] in _HUBERT_TRAINING_ONLY}
    exp = expected_hubert_sd_shapes(num_layers)
    missing = sorted(set(exp) - set(shapes))
    unexpected = sorted(set(shapes) - set(exp) - ignored)
    mismatched = [f"{k}: got {shapes[k]} want {exp[k]}"
                  for k in sorted(exp) if k in shapes and shapes[k] != exp[k]]
    if missing or unexpected or mismatched:
        raise ValueError(
            "checkpoint does not match the bshall/hubert HubertSoft state-dict "
            f"contract:\n  missing={missing[:8]}\n  unexpected={unexpected[:8]}\n"
            f"  shape_mismatches={mismatched[:8]}")


def hubert_params_from_state_dict(sd: Mapping[str, Any], num_layers: int = 12) -> dict:
    """A bshall ``HubertSoft`` state dict -> the JAX ``HubertSoft``
    parameter tree of float32 numpy arrays, checked first against the key
    contract (:func:`validate_hubert_sd`), in the key order
    ``quickvc_tpu/utils/hubert_port.py:port_hubert`` builds."""
    validate_hubert_sd(sd, num_layers)
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def linear(key):
        return {"kernel": np.ascontiguousarray(_leaf(sd[key + ".weight"]).T),
                "bias": _leaf(sd[key + ".bias"])}

    def ln(key):
        return {"scale": _leaf(sd[key + ".weight"]), "bias": _leaf(sd[key + ".bias"])}

    fe = {"norm0": ln("feature_extractor.norm0")}
    for i in range(7):
        fe[f"conv{i}"] = {"kernel": _jax_conv(sd, f"feature_extractor.conv{i}", "weight")}
    pos = {"v": _jax_conv(sd, "positional_embedding.conv"),
           "g": _leaf(sd["positional_embedding.conv.weight_g"]).reshape(-1),
           "bias": _leaf(sd["positional_embedding.conv.bias"])}
    layers = {}
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        layers[f"layer_{i}"] = {
            "self_attn": {"in_proj_weight": _leaf(sd[f"{p}.self_attn.in_proj_weight"]),
                          "in_proj_bias": _leaf(sd[f"{p}.self_attn.in_proj_bias"]),
                          "out_proj": linear(f"{p}.self_attn.out_proj")},
            "norm1": ln(f"{p}.norm1"), "norm2": ln(f"{p}.norm2"),
            "linear1": linear(f"{p}.linear1"), "linear2": linear(f"{p}.linear2")}
    return {"feature_extractor": fe,
            "feature_projection": {"norm": ln("feature_projection.norm"),
                                   "projection": linear("feature_projection.projection")},
            "positional_embedding": pos, "norm": ln("norm"), **layers, "proj": linear("proj")}


# --------------------------------------------------------------------------
# checkpoint files


def decoder_buffer(key: str) -> bool:
    """A decoder constant that no JAX parameter holds and no export carries:
    the multistream decoder's ``dec.updown_filter``, and a reference
    checkpoint's iSTFT Hann window (``dec.*stft.window``) and PQMF filters
    (``dec.pqmf.*``)."""
    return key.startswith("dec.") and (key == "dec.updown_filter" or key.endswith("stft.window")
                                       or key.startswith("dec.pqmf."))


def load_generator(path: str, model: nn.Module) -> None:
    """Load a generator strictly: a reference ``G_*.pth`` (``{"model": sd,
    ...}`` or a bare sd), or the JAX package's ``.msgpack`` parameter file
    (``scripts/export_params.py``), mapped by
    :func:`generator_state_dict_from_jax` for ``model.model_cfg``.

    The reference's decoders carry constant buffers: torchaudio's
    ``InverseSpectrogram`` Hann window and a PQMF module's filters (the
    port's head and :mod:`quickvc_tpu_torch.dsp.pqmf` build their own) are
    dropped, and the multistream decoder's ``dec.updown_filter``, which
    exports from the JAX package lack, is built here (:func:`decoder_buffer`
    names all three). The tensors are
    assigned, so the model may be built on the ``meta`` device without
    initializing anything.
    """
    if str(path).endswith(".msgpack"):
        sd = generator_state_dict_from_jax(load_params(path), model.model_cfg)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    sd = {k: v for k, v in sd.items() if not decoder_buffer(k)}
    if hasattr(model.dec, "updown_filter"):
        sd["dec.updown_filter"] = torch.from_numpy(_updown_filter(model.dec.subbands))
    model.load_state_dict(sd, strict=True, assign=True)


def load_discriminator(path: str, model: nn.Module) -> None:
    """Load a reference ``D_*.pth`` (``{"model": sd, ...}`` or a bare sd) strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    model.load_state_dict(sd, strict=True)


def load_hubert(path: str, model: nn.Module) -> None:
    """Load a bshall ``hubert-soft.pt`` (``{"hubert": sd}`` or a bare sd), or
    the JAX package's HuBERT ``.msgpack`` (``scripts/export_params.py
    --hubert-out``, mapped by :func:`hubert_state_dict_from_jax`), strictly.

    Checks the key contract first, strips a ``module.`` prefix (checkpoints
    saved from DataParallel) and the training-only entries. The tensors are
    assigned, as in :func:`load_generator`.
    """
    if str(path).endswith(".msgpack"):
        sd = hubert_state_dict_from_jax(load_params(path))
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("hubert", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: v for k, v in sd.items() if hasattr(v, "shape")}
    validate_hubert_sd(sd, num_layers=len(model.encoder.layers))
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if k.split(".")[0] not in _HUBERT_TRAINING_ONLY}
    model.load_state_dict(sd, strict=True, assign=True)


# --------------------------------------------------------------------------
# seeded random weights


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Give every parameter a seeded draw with fan-in scaling.

    Weights are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) like torch's defaults,
    weight-norm gains equal ||v|| so the normalized weight is v, biases and
    LayerNorm/GroupNorm shifts are zero and their scales one. Drawn on the
    CPU, so a seed gives the same weights on every device.
    """
    gen = torch.Generator().manual_seed(seed)
    params = dict(model.named_parameters())
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight_g":
            continue
        if p.dim() == 1:
            is_scale = leaf == "weight"  # norm scales are the only 1-d weights
            p.copy_(torch.ones_like(p) if is_scale else torch.zeros_like(p))
            continue
        fan_in = p[0].numel() if p.dim() > 1 else 1
        if leaf.startswith("weight_hh") or leaf.startswith("weight_ih"):
            fan_in = p.shape[0] // 4  # torch LSTM init: U(+-1/sqrt(hidden))
        bound = 1.0 / math.sqrt(fan_in)
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    for name, p in params.items():
        if name.endswith("weight_g"):
            v = params[name[: -len("weight_g")] + "weight_v"]
            dims = [d for d in range(v.dim()) if p.shape[d] == 1]
            p.copy_(torch.linalg.vector_norm(v, dim=dims, keepdim=True))
    return model
