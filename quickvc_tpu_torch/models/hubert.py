"""HuBERT-soft content encoder, wave -> 256-d soft units, bshall/hubert key layout.

Port of ``quickvc_tpu/models/hubert.py``: 7-conv 512-wide feature extractor
(GroupNorm after conv0), LayerNorm + 768-d projection, grouped positional
conv (k=128, 16 groups, weight norm over dim 2, trailing sample trimmed),
LayerNorm, 12 post-norm transformer layers whose attention core is kernel
K2 on the packed q/k/v (or, with ``use_fused_layer``, each layer whole as
kernel K8), and the 256-d soft projection. Keys follow
``quickvc_tpu/utils/hubert_port.py:expected_hubert_sd_shapes``, so a bshall
``hubert-soft.pt`` loads strictly (``utils/weights.py:load_hubert``).

It computes in the wave's dtype, as the JAX package does: a bf16 wave runs
every conv and linear in bf16 (float32 parameters cast where used), the
norms in float32 on the upcast input with the result cast back
(``norm_like``), GELU in its tanh form, and attention through K2's bf16 mode
on the card. The ``pallas`` front (K7) and the fused layer (K8) take a bf16
wave or hidden state through their bf16 modes, rounding where the TPU
kernels round at bf16 (their plain versions on the CPU).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.models.layers import Conv1d, Linear, WNConv1d, cast_like, norm_like
from quickvc_tpu_torch.ops.fused_attention import attention_packed
from quickvc_tpu_torch.ops.fused_extractor import extractor_front, groupnorm_affine_closed_form
from quickvc_tpu_torch.ops.fused_transformer import transformer_layer

FRONTS = ("faststats", "xla", "pallas")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in float32; the tanh form in bf16 (models/hubert.py:48-60)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class FeatureExtractor(nn.Module):
    """Wave (B, T) -> features (B, 512, ~T/320).

    ``front`` picks how conv0's GroupNorm is taken: ``"xla"`` reduces over
    conv0's output like the reference; ``"faststats"`` (the serving default)
    gets the same affine in closed form from the wave
    (``ops/fused_extractor.py``); ``"pallas"`` runs conv0, that affine, GELU,
    conv1 and GELU as kernel K7 (its plain version on the CPU). The names
    follow the JAX package's ``--hubert-front`` choices.
    """

    def __init__(self, channels: int = 512, front: str = "faststats"):
        super().__init__()
        if front not in FRONTS:
            raise ValueError(f"front {front!r} not in {FRONTS}")
        self.front = front
        c = channels
        self.conv0 = Conv1d(1, c, 10, 5, bias=False)
        self.norm0 = nn.GroupNorm(c, c)
        for i in range(1, 5):
            setattr(self, f"conv{i}", Conv1d(c, c, 3, 2, bias=False))
        for i in range(5, 7):
            setattr(self, f"conv{i}", Conv1d(c, c, 2, 2, bias=False))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if self.front == "pallas":  # conv0 through conv1's GELU in one pass
            x = extractor_front(wav, self.conv0.weight, self.norm0.weight, self.norm0.bias,
                                self.conv1.weight).transpose(1, 2)
            first = 2
        else:
            y = self.conv0(wav[:, None])
            if self.front == "faststats":
                scale, shift = groupnorm_affine_closed_form(
                    wav, self.conv0.weight, self.norm0.weight, self.norm0.bias)
                x = gelu(y * scale[:, :, None].to(y.dtype) + shift[:, :, None].to(y.dtype))
            else:
                x = gelu(norm_like(self.norm0, y))
            first = 1
        for i in range(first, 7):
            x = gelu(getattr(self, f"conv{i}")(x))
        return x


class FeatureProjection(nn.Module):
    def __init__(self, conv_dim: int = 512, embed_dim: int = 768):
        super().__init__()
        self.norm = nn.LayerNorm(conv_dim)
        self.projection = Linear(conv_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(norm_like(self.norm, x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self, embed_dim: int = 768, kernel_size: int = 128, groups: int = 16):
        super().__init__()
        self.conv = WNConv1d(embed_dim, embed_dim, kernel_size, padding=kernel_size // 2,
                             groups=groups, norm_dim=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, D); the even kernel's trailing sample is trimmed."""
        y = self.conv(x.transpose(1, 2))
        return gelu(y[:, :, :-1]).transpose(1, 2)


class SelfAttention(nn.Module):
    """``nn.MultiheadAttention`` parameters; the core runs through K2."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = F.linear(x, *cast_like(x, self.in_proj_weight, self.in_proj_bias)).chunk(3, dim=-1)
        d = x.shape[-1] // self.num_heads
        return self.out_proj(attention_packed(q, k, v, self.num_heads, 1.0 / math.sqrt(d)))


class TransformerLayer(nn.Module):
    """Post-norm encoder layer (torch ``TransformerEncoderLayer``, GELU).

    ``use_fused_layer=True``, the counterpart of the JAX package's
    ``use_pallas_layer``, runs the whole layer as kernel K8
    (``ops/fused_transformer.py``; its plain version on the CPU) with the
    same parameters; off by default, as in JAX.
    """

    def __init__(self, embed_dim: int = 768, num_heads: int = 12, ffn_dim: int = 3072,
                 use_fused_layer: bool = False):
        super().__init__()
        self.use_fused_layer = use_fused_layer
        self.self_attn = SelfAttention(embed_dim, num_heads)
        self.linear1 = Linear(embed_dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused_layer:
            return transformer_layer(x, self)
        x = norm_like(self.norm1, x + self.self_attn(x))
        return norm_like(self.norm2, x + self.linear2(gelu(self.linear1(x))))


class Encoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer(**layer_kw) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class HubertSoft(nn.Module):
    """Wave (B, T) -> soft units (B, T//320, unit_dim) via :meth:`units`.

    ``front`` is :class:`FeatureExtractor`'s and ``use_fused_layer``
    :class:`TransformerLayer`'s; neither changes a state-dict key.
    """

    def __init__(self, embed_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 ffn_dim: int = 3072, extractor_channels: int = 512, unit_dim: int = 256,
                 pos_kernel_size: int = 128, pos_groups: int = 16,
                 front: str = "faststats", use_fused_layer: bool = False):
        super().__init__()
        self.feature_extractor = FeatureExtractor(extractor_channels, front)
        self.feature_projection = FeatureProjection(extractor_channels, embed_dim)
        self.positional_embedding = PositionalConvEmbedding(embed_dim, pos_kernel_size,
                                                            pos_groups)
        self.norm = nn.LayerNorm(embed_dim)
        self.encoder = Encoder(num_layers, embed_dim=embed_dim, num_heads=num_heads,
                               ffn_dim=ffn_dim, use_fused_layer=use_fused_layer)
        self.proj = Linear(embed_dim, unit_dim)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_extractor(wav).transpose(1, 2)
        x = self.feature_projection(x)
        x = norm_like(self.norm, x + self.positional_embedding(x))
        return self.proj(self.encoder(x))

    def units(self, wav: torch.Tensor) -> torch.Tensor:
        """Reference ``HubertSoft.units``: pad (400-320)//2 samples both sides first."""
        pad = (400 - 320) // 2
        return self(F.pad(wav, (pad, pad)))
