"""A/B of the period discriminator's fifth conv at bf16: cuDNN against kernels K5/K6.

Port of ``scripts/disc_pallas_ab.py``, which asks the same of the Pallas
kernel on the TPU. At training shapes (a paired batch of 128 waves of 10,240
samples, bf16), each a parameter gradient of ``mean((logit - 1)^2)``:

1. ``baseline``: the weight-normed conv stack of ``DiscriminatorP``.
2. ``outscale``: weight norm applied to each conv's OUTPUT (y * g/||v|| + b)
   instead of to its kernel; the same function.
3. ``pallas_l5``: the fifth conv (1024 -> 1024, (5, 1), stride 1) runs as
   ``ops.fused_disc_conv.conv5_lrelu`` (K5 forward and dx, K6 dW, in their
   bf16 mode) on the weight-normed kernel and bias cast to bf16.

Before them, the fifth conv alone at the script's shapes (x (128 p, R, 1024),
R = ceil(10240 / p) // 27, seed-0 inputs x 0.1 and filter x 0.02, zero
bias, all bf16), forward and the filter's gradient of ``sum(y^2)``: cuDNN
(``F.conv1d`` + LeakyReLU on the (N, C, R) layout, transposed before the
timing) against K5/K6.

    python -m quickvc_tpu_torch.scripts.disc_pallas_ab [--device cuda|cpu] [--iters 10]

Seeded random weights (``utils.weights.init_random_``, seed 0 for every
variant) and numpy seed-0 inputs. Each timing is the best of 3 repeats of
``--iters`` calls (CUDA events on the card, the host clock on the CPU) and
prints one JSON line: its name, ms a call, whether every output of a call
was finite, and the K5/K6 bf16 launches a call made. ``--batch`` and
``--samples`` (default 128 and 10,240, the JAX script's) exist so that a
CPU test can run it small; on the CPU the kernels' plain versions run.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from quickvc_tpu_torch.models.discriminators import DiscriminatorP
from quickvc_tpu_torch.models.layers import WNConv2d, conv, leaky_relu

MODES = ("baseline", "outscale", "pallas_l5")
COUNTED = ("conv5_lrelu_bf16", "conv5_lrelu_dw_bf16")   # launches reported a call


class WNConv2dOutScale(WNConv2d):
    """Weight norm as an output-channel scale: y = conv(x, v) * g/||v|| + b
    (the JAX script's ``WNConv2dOutScale``, with its 1e-12 under the root)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        y = conv(F.conv2d, x, v, None, self.stride, self.padding)
        scale = self.weight_g.flatten() / torch.sqrt(torch.sum(v * v, dim=(1, 2, 3)) + 1e-12)
        return y * scale.to(y.dtype)[:, None, None] + self.bias.to(y.dtype)[:, None, None]


class DiscPVariant(DiscriminatorP):
    """``DiscriminatorP`` with a selectable conv implementation (``MODES``),
    returning its logits only. ``pallas_l5`` is ``fused_conv5=True``; its
    fifth conv holds the JAX script's ``l5_v``, ``l5_g`` and ``l5_bias``
    (``utils.weights.disc_variant_state_dict_from_jax``)."""

    def __init__(self, period: int, mode: str = "baseline"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        super().__init__(period, fused_conv5=mode == "pallas_l5")
        self.mode = mode
        if mode == "outscale":
            self.convs = nn.ModuleList(
                WNConv2dOutScale(c.weight_v.shape[1], c.weight_v.shape[0],
                                 tuple(c.weight_v.shape[2:]), c.stride, c.padding)
                for c in self.convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--iters", type=int, default=10, help="calls a repeat (3 repeats, best kept)")
    p.add_argument("--batch", type=int, default=128, help="waves (the paired batch)")
    p.add_argument("--samples", type=int, default=10240, help="samples a wave")
    return p.parse_args(argv)


def timeit(name: str, fn, device: torch.device, iters: int, kind: str) -> dict:
    """Best of 3 repeats of ``iters`` calls of ``fn`` after one warm-up call;
    the launches of one more call, and whether its outputs were finite."""
    from quickvc_tpu_torch import ops
    from quickvc_tpu_torch.scripts import time_ms

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ops.reset_launch_counts()
    outs = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v for k, v in ops.launch_counts().items() if k in COUNTED}
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    ms = min(time_ms(fn, device, iters, warmup=0) for _ in range(3))
    line = {"name": name, "ms": ms, "finite": finite, "launches": launches, "device": kind}
    print(json.dumps(line), flush=True)
    return line


def isolated_l5(rng: np.random.Generator, period: int, device: torch.device, args,
                kind: str) -> list[dict]:
    """The fifth conv alone at the stack's shape, cuDNN against K5/K6, forward
    and the filter's gradient."""
    from quickvc_tpu_torch.ops.fused_disc_conv import conv5_lrelu

    rows = -(-args.samples // period) // 27   # after 3 stride-3 convs
    n = args.batch * period
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((n, rows, 1024)).astype(np.float32) * 0.1
                         ).to(device).to(bf)
    k = torch.from_numpy(rng.standard_normal((5, 1024, 1024)).astype(np.float32) * 0.02
                         ).to(device).to(bf)
    b = torch.zeros(1024, device=device, dtype=bf)
    x_ncr = x.transpose(1, 2).contiguous()       # cuDNN's (N, C, R)
    w_oik = k.permute(2, 1, 0).contiguous()      # (C_out, C_in, 5)

    def cudnn(w):
        return leaky_relu(conv(F.conv1d, x_ncr, w, b, 1, 2))

    def fused(kk):
        return conv5_lrelu(x, kk, b, 0.1)

    lines = []
    for name, f, w in (("cudnn", cudnn, w_oik), ("fused", fused, k)):
        lines.append(timeit(f"L5_p{period}_{name}_fwd", lambda f=f, w=w: [f(w)], device,
                            args.iters, kind))

        def grad(f=f, w=w):
            leaf = w.detach().requires_grad_()
            return torch.autograd.grad((f(leaf).float() ** 2).sum(), leaf)
        lines.append(timeit(f"L5_p{period}_{name}_grad", grad, device, args.iters, kind))
    return lines


def main(argv=None) -> list[dict]:
    """Run the A/B; returns the timing lines."""
    from quickvc_tpu_torch.utils.device import resolve_device
    from quickvc_tpu_torch.utils.weights import init_random_

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((args.batch, 1, args.samples)).astype(np.float32)
                         * 0.1).to(device).to(torch.bfloat16)

    lines = []
    for period in (2, 11):
        lines += isolated_l5(rng, period, device, args, kind)
    for period in (2, 5, 11):
        for mode in MODES:
            m = init_random_(DiscPVariant(period, mode), 0).to(device)
            params = list(m.parameters())

            def grad(m=m, params=params):
                loss = torch.mean((m(x).float() - 1) ** 2)
                return torch.autograd.grad(loss, params)
            lines.append(timeit(f"disc_p{period}_{mode}_grad", grad, device, args.iters, kind))
    return lines


if __name__ == "__main__":
    main()
