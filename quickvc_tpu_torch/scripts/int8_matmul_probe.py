"""Int8 GEMM probe of the port: does the hand-written tensor-core kernel K11 reach the int8 rate?

Port of ``scripts/int8_matmul_probe.py``, which asks the same of a Pallas
kernel on the TPU. Shape: 16 HuBERT FFN products' worth of work folded into
one GEMM, (16384 x 12288) @ (12288 x 3072) = 1.24 TOP.

    python -m quickvc_tpu_torch.scripts.int8_matmul_probe [--device cuda|cpu] [--iters 8]

A and B are int8 in [-127, 127] from numpy seed 0, as in the JAX probe, and
their bf16 copies divided by 127. The probe checks the whole int8 product of
``ops.int8_mm.mm`` against the plain version exactly (the JAX probe checks an
8 x 8 corner) and the bf16 product within atol 2e-3 / rtol 1e-4 (float32
sums in another order), then times, one JSON line each with ms and TOP/s:
the kernel in int8 and in bf16; ``torch._int_mm`` on B as given and on a
column-major copy of B made before the timing (the layout cuBLASLt's int8
kernels take), and bf16 ``torch.matmul``, library yardsticks the port does
not call; the kernel at every compiled tile
(:data:`quickvc_tpu_torch.ops.int8_mm.TILES`) in both types. On the card the
times are CUDA events; with ``--device cpu`` the plain version runs, the
sweep is skipped (the kernel needs the card) and the times are the host's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from quickvc_tpu_torch.ops.int8_mm import TILES, mm, mm_kernel, mm_reference
from quickvc_tpu_torch.scripts import time_ms
from quickvc_tpu_torch.utils.device import resolve_device

M, K, N = 16384, 12288, 3072
BF16_ATOL, BF16_RTOL = 2e-3, 1e-4


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--iters", type=int, default=8, help="timed calls per line")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the probe; returns the checks and the timed lines. Raises if the
    kernel's int8 product is not exact or its bf16 product is off."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).to(device)
    b8 = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(device)
    abf, bbf = ((x.float() / 127.0).to(torch.bfloat16) for x in (a8, b8))

    want = mm_reference(a8, b8)
    want_bf = mm_reference(abf, bbf)

    def bf16_err(got):
        diff = (got - want_bf).abs()
        return float(diff.max()), bool((diff <= BF16_ATOL + BF16_RTOL * want_bf.abs()).all())

    err, ok = bf16_err(mm(abf, bbf))
    checks = {"s8_exact": bool(torch.equal(mm(a8, b8), want)), "bf16_max_abs_err": err,
              "bf16_within_tol": ok, "bf16_atol": BF16_ATOL, "bf16_rtol": BF16_RTOL}
    if device.type == "cuda":
        for tile in TILES:
            checks[f"s8_exact_{tile}"] = bool(torch.equal(mm_kernel(a8, b8, tile), want))
            checks[f"bf16_within_tol_{tile}"] = bf16_err(mm_kernel(abf, bbf, tile))[1]
    print(json.dumps({"probe": "int8_mm", "device": kind, "shape": [M, K, N]} | checks),
          flush=True)
    del want, want_bf
    bad = [k for k, v in checks.items() if v is False]
    if bad:
        raise RuntimeError(f"int8_matmul_probe: kernel differs from its plain version: {bad}")

    b8_col = b8.t().contiguous().t()   # the column-major B cuBLASLt's int8 kernels prefer
    calls = [("mm_s8", lambda: mm(a8, b8)), ("mm_bf16", lambda: mm(abf, bbf)),
             ("library_int_mm_s8", lambda: torch._int_mm(a8, b8)),
             ("library_int_mm_s8_b_col_major", lambda: torch._int_mm(a8, b8_col)),
             ("library_matmul_bf16", lambda: torch.matmul(abf, bbf))]
    if device.type == "cuda":
        calls += [(f"mm_{name}_{tile}", lambda x=x, y=y, tile=tile: mm_kernel(x, y, tile))
                  for name, x, y in (("s8", a8, b8), ("bf16", abf, bbf)) for tile in TILES]
    lines = []
    for name, fn in calls:
        ms = time_ms(fn, device, args.iters)
        line = {"name": name, "device": kind, "ms": ms, "tops": 2 * M * K * N / ms / 1e9}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return {"device": kind, "checks": checks, "lines": lines}


if __name__ == "__main__":
    main()
