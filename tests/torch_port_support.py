"""Shared set-up of the PyTorch-port tests: tiny JAX models, their weights in
the port, a numpy emulation of the kernels' 3xTF32 tensor-core arithmetic,
a numpy model of the real FFT that K1 and K4 share, the JAX log-mel
kernels' size rule, and bf16 bit patterns read back as values or tensors.

Inputs and weights come from numpy seeds; weights cross from
the flax parameter trees through ``quickvc_tpu_torch.utils.weights``. JAX is
imported by the functions that build JAX models, so a test that uses only
the emulation imports none of it.
"""

from __future__ import annotations

import numpy as np
import torch

# torch's CPU ops take one intra-op thread a core by default; with several
# pytest workers on one host that oversubscribes it, and at these tiny widths
# the threads cost more than they save. Every port test that runs torch ops
# imports this module (spawned loader workers start with their own default).
torch.set_num_threads(min(2, torch.get_num_threads()))

from quickvc_tpu_torch.config import ModelConfig  # noqa: E402
from quickvc_tpu_torch.ops import fused_mel  # noqa: E402

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


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (``quickvc_tpu_torch.utils.bf16.to_bits``) -> the
    float32 values they stand for (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """bf16 bit patterns -> a ``torch.bfloat16`` tensor sharing their memory."""
    return torch.from_numpy(np.ascontiguousarray(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16)


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


def mma(c: np.ndarray, a: np.ndarray, b: np.ndarray | None, passes: int,
        promote: bool = False, rz: bool = False,
        b_parts: tuple[np.ndarray, np.ndarray] | None = None) -> np.ndarray:
    """c + a @ b over 8-wide k chunks, float32 accumulation; 3xTF32 or one TF32 pass.

    ``promote``: each chunk's products are summed from zero and then added
    to c by a float32 add (K5-K8); otherwise they go into c itself (the
    attention body). ``rz``: the sums inside an mma truncate (:func:`add_rz`).
    ``b_parts``: B given already split, (big, small) as :func:`split` gives
    them (K7 stores its B so), in place of ``b``; 3xTF32 only.
    """
    for k0 in range(0, a.shape[-1], 8):
        ac = a[..., k0:k0 + 8]
        if passes == 3:
            ab, as_ = split(ac)
            bb, bs = ([p[..., k0:k0 + 8, :] for p in b_parts] if b_parts is not None
                      else split(b[..., k0:k0 + 8, :]))
            terms = (as_, bb), (ab, bs), (ab, bb)
        else:
            terms = ((tf32(ac), tf32(b[..., k0:k0 + 8, :])),)
        t = np.zeros_like(c) if promote else c
        for x, y in terms:   # products of TF32 values are exact in float64
            prod = x.astype(np.float64) @ y.astype(np.float64)
            t = add_rz(t, prod) if rz else (t + prod.astype(np.float32)).astype(np.float32)
        c = (c + t).astype(np.float32) if promote else t
    return c.astype(np.float32)


# The real FFT of K4 and of K1's FFT route, in numpy, from the plan and
# table the wrappers hand the kernel.


def _dft(v):
    """Radix-len(v) butterfly: the length-R DFT of R complex rows."""
    r = len(v)
    w = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r).astype(np.complex64)
    return [sum(w[q, s] * v[s] for s in range(r)) for q in range(r)]


def kernel_spec(frames: np.ndarray, n_fft: int, win: int) -> np.ndarray:
    """(F, n_fft) float32 frames -> (F, n_fft/2+1) magnitudes, as the FFT
    routes of K4 and K1 compute them (``csrc/fused_mel.cu:spec_fft`` and
    ``spec_magnitude``) from the plan and table the wrappers hand them."""
    radices = fused_mel.fft_plan(n_fft)
    table = fused_mel.spec_fft_table(n_fft, win)
    m = n_fft // 2
    window = table[table.size - n_fft:]
    z = (frames[:, 0::2] * window[0::2]) + 1j * (frames[:, 1::2] * window[1::2])
    off, ns = 0, 1
    for r in radices:                       # Stockham pass: z -> out
        nb = m // r
        j = np.arange(nb)
        k = j % ns
        v = [z[:, j + q * nb] for q in range(r)]
        for q in range(1, r):
            at = off + 2 * (k * (r - 1) + q - 1)
            v[q] = v[q] * (table[at] + 1j * table[at + 1]).astype(np.complex64)
        out = np.empty_like(z)
        for q, vq in enumerate(_dft(v)):
            out[:, (j - k) * r + k + q * ns] = vq
        z, off, ns = out, off + 2 * ns * (r - 1), ns * r
    assert ns == m
    k = np.arange(m + 1)
    tw = table[off + 2 * k] + 1j * table[off + 2 * k + 1]
    zk, zc = z[:, k % m], np.conj(z[:, (m - k) % m])
    x = 0.5 * (zk + zc) - 0.5j * tw * (zk - zc)
    x[:, 0] = z[:, 0].real + z[:, 0].imag     # bins 0 and n_fft/2 apart, exactly
    x[:, m] = z[:, 0].real - z[:, 0].imag
    return np.sqrt(x.real ** 2 + x.imag ** 2 + 1e-6).astype(np.float32)


# The JAX log-mel kernels' size rule (quickvc_tpu/ops/fused_mel.py asserts
# hop | n_fft and hop | 2*((n_fft-hop)//2)), restated as arithmetic.


def jax_mel_accepts(n_fft: int, hop: int) -> bool:
    return n_fft % hop == 0 and (2 * ((n_fft - hop) // 2)) % hop == 0


def divisors(n: int) -> list[int]:
    hops = np.arange(1, n + 1)
    return hops[n % hops == 0].tolist()


GRID_MEL = [(400, 100), (800, 200), (1000, 250), (1200, 300), (1536, 384), (2048, 512),
            (1280, 320), (1024, 256), (4096, 1024), (4096, 4096), (9, 3)]
