"""Shared set-up of the PyTorch-port tests: tiny JAX models, their weights in the port.

Inputs and weights come from numpy seeds; weights cross from
the flax parameter trees through ``quickvc_tpu_torch.utils.weights``.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from quickvc_tpu.config import ModelConfig as JaxModelConfig
from quickvc_tpu_torch.config import ModelConfig

TINY_MODEL = dict(inter_channels=16, hidden_channels=16, upsample_initial_channel=32,
                  gin_channels=16, unit_channels=24, resblock_kernel_sizes=(3, 5),
                  resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
                  enc_wn_layers=3, flow_wn_layers=2, n_flows=2)
TINY_HUBERT = dict(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
                   extractor_channels=32, unit_dim=24, pos_kernel_size=8, pos_groups=4)
SPEC_CH = 33


def random_params(module, seed: int, *init_args, scale: float = 0.1):
    """Seeded numpy parameters in the structure of ``module.init`` (traced
    with ``jax.eval_shape``, nothing compiled): N(0, scale^2) for every leaf,
    plus 1 for weight-norm gains and norm scales so they sit near their
    usual values. No weight is left at an init constant such as the zero
    post convs of the flow."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, *init_args)["params"]

    def draw(path, x):
        v = scale * rng.standard_normal(x.shape)
        if getattr(path[-1], "key", None) in ("g", "scale"):
            v = v + 1.0
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def tiny_generator(seed: int = 0):
    """(JAX SynthesizerTrn, seeded numpy params, port SynthesizerTrn) at TINY_MODEL."""
    from quickvc_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
    from quickvc_tpu_torch.models.synthesizer import SynthesizerTrn
    from quickvc_tpu_torch.utils.weights import generator_state_dict_from_jax

    jmc = JaxModelConfig(**TINY_MODEL)
    net = JaxSynth(spec_channels=SPEC_CH, segment_size=8, model=jmc)
    f, key = 24, jax.random.PRNGKey(0)
    params = random_params(net, seed, {"params": key, "sample": key, "slice": key},
                           jnp.zeros((1, f, jmc.unit_channels)),
                           jnp.zeros((1, f, SPEC_CH)), jnp.zeros((1, f, 80)))
    mc = ModelConfig(**TINY_MODEL)
    port = SynthesizerTrn(SPEC_CH, 8, mc)
    port.load_state_dict(generator_state_dict_from_jax(params, mc), strict=True)
    return net, params, port.eval()


def tiny_hubert(front: str, seed: int = 0, fused_layer: bool = False):
    """(JAX HubertSoft, numpy params, port HubertSoft) at TINY_HUBERT;
    ``fused_layer`` sets the port's ``use_fused_layer`` and JAX's ``use_pallas_layer``."""
    from quickvc_tpu.models.hubert import HubertSoft as JaxHubert
    from quickvc_tpu_torch.models.hubert import HubertSoft
    from quickvc_tpu_torch.utils.weights import hubert_state_dict_from_jax

    jnet = JaxHubert(front_mode=front, use_pallas_layer=fused_layer, **TINY_HUBERT)
    params = random_params(jnet, seed, jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
    port = HubertSoft(front=front, use_fused_layer=fused_layer, **TINY_HUBERT)
    port.load_state_dict(hubert_state_dict_from_jax(params), strict=True)
    return jnet, params, port.eval()


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))
