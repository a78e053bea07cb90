"""Shared set-up of the PyTorch-port tests: tiny JAX models, their weights in
the port, and a numpy emulation of the kernels' 3xTF32 tensor-core arithmetic.

Inputs and weights come from numpy seeds; weights cross from
the flax parameter trees through ``quickvc_tpu_torch.utils.weights``. JAX is
imported by the functions that build JAX models, so a test that uses only
the emulation imports none of it.
"""

from __future__ import annotations

import numpy as np
import torch

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
    import jax

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
    import jax
    import jax.numpy as jnp

    from quickvc_tpu.config import ModelConfig as JaxModelConfig
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
    import jax
    import jax.numpy as jnp

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


# 3xTF32 as csrc/tf32x3.cuh computes it: each float32 operand x split into
# big, x rounded to TF32 as cvt.rna rounds (add 0x1000 to the bits, mask with
# 0xFFFFE000), and small = x - big, which the tensor core reads to its top
# 10 mantissa bits (mask only); every product taken as small*big +
# big*small, then big*big, one 8-wide k chunk at a time into a float32
# accumulator (as mma.sync.m16n8k8 does).


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(x: np.ndarray) -> np.ndarray:
    """A float32 operand as the tensor core reads it: the top 10 mantissa bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = tf32(x)
    return big, tf32_read(x.astype(np.float32) - big)


def add_rz(c: np.ndarray, p: np.ndarray) -> np.ndarray:
    """c + p rounded toward zero to float32: a model of the tensor core's
    in-mma sum, which truncates where an IEEE add rounds to nearest."""
    exact = c.astype(np.float64) + p
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def mma(c: np.ndarray, a: np.ndarray, b: np.ndarray, passes: int, promote: bool = False,
        rz: bool = False) -> np.ndarray:
    """c + a @ b over 8-wide k chunks, float32 accumulation; 3xTF32 or one TF32 pass.

    ``promote``: each chunk's products are summed from zero and then added
    to c by a float32 add (K5/K6); otherwise they go into c itself (the
    attention body). ``rz``: the sums inside an mma truncate (:func:`add_rz`).
    """
    for k0 in range(0, a.shape[-1], 8):
        ac, bc = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if passes == 3:
            (ab, as_), (bb, bs) = split(ac), split(bc)
            terms = (as_, bb), (ab, bs), (ab, bb)
        else:
            terms = ((tf32(ac), tf32(bc)),)
        t = np.zeros_like(c) if promote else c
        for x, y in terms:   # products of TF32 values are exact in float64
            prod = x.astype(np.float64) @ y.astype(np.float64)
            t = add_rz(t, prod) if rz else (t + prod.astype(np.float32)).astype(np.float32)
        c = (c + t).astype(np.float32) if promote else t
    return c.astype(np.float32)
