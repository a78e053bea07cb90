"""PyTorch port, kernel K11: the plain version of the int8/bf16 GEMM against
the JAX probe's ``pallas_mm`` (Pallas TPU interpret mode) and the port's
probe CLI on the CPU, both at (64 x 256) @ (256 x 128) instead of the
probe's full shape; the persistent kernel's tile schedule
(``ops.int8_mm.tile_schedule``, the twin of the kernel's) at the probe's
shape and at ragged ones, no JAX.

Tolerances: int8 exact (both sum in int32 or exactly in float64); bf16 atol
1e-5 (the same bf16 values summed in float32 in another order).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_support import t

REPO = Path(__file__).resolve().parents[1]
SMALL = {"M": 64, "K": 256, "N": 128}


@pytest.fixture
def jax_probe(monkeypatch):
    """``scripts/int8_matmul_probe.py`` loaded as a module, its shape made small."""
    spec = importlib.util.spec_from_file_location("jax_int8_matmul_probe",
                                                  REPO / "scripts" / "int8_matmul_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in SMALL.items():
        monkeypatch.setattr(mod, name, value)
    return mod


def test_plain_matches_pallas_mm(rng, jax_probe):
    from jax.experimental.pallas import tpu as pltpu

    from quickvc_tpu_torch.ops import int8_mm, reset_launch_counts

    a8 = rng.integers(-127, 128, (SMALL["M"], SMALL["K"]), dtype=np.int8)
    b8 = rng.integers(-127, 128, (SMALL["K"], SMALL["N"]), dtype=np.int8)
    abf, bbf = ((x.astype(np.float32) / 127.0).astype(jnp.bfloat16) for x in (a8, b8))
    with pltpu.force_tpu_interpret_mode():
        golden8 = np.asarray(jax_probe.pallas_mm(jnp.asarray(a8), jnp.asarray(b8),
                                                 bm=32, bn=128, bk=128))
        golden_bf = np.asarray(jax_probe.pallas_mm(jnp.asarray(abf), jnp.asarray(bbf),
                                                   bm=32, bn=128, bk=128))
    assert golden8.dtype == np.int32 and golden_bf.dtype == np.float32

    reset_launch_counts()
    ours8 = int8_mm.mm(t(a8), t(b8))
    ours_bf = int8_mm.mm(*(t(x.astype(np.float32)).bfloat16() for x in (abf, bbf)))
    assert int8_mm.S8_STATS.launches == int8_mm.BF16_STATS.launches == 0
    assert ours8.dtype == torch.int32
    np.testing.assert_array_equal(ours8.numpy(), golden8)
    np.testing.assert_allclose(ours_bf.numpy(), golden_bf, atol=1e-5, rtol=0)


def test_probe_cli_on_cpu(monkeypatch, capsys):
    """The port's probe at the small shape: exact, every line on the CPU."""
    from quickvc_tpu_torch.scripts import int8_matmul_probe as probe

    for name, value in SMALL.items():
        monkeypatch.setattr(probe, name, value)
    out = probe.main(["--device", "cpu", "--iters", "1"])
    assert out["device"] == "cpu"
    assert out["checks"]["s8_exact"] and out["checks"]["bf16_within_tol"]
    names = [line["name"] for line in out["lines"]]
    assert names == ["mm_s8", "mm_bf16", "library_int_mm_s8", "library_int_mm_s8_b_col_major",
                     "library_matmul_bf16"]
    assert all(line["ms"] > 0 for line in out["lines"])
    assert '"device": "cpu"' in capsys.readouterr().out


def test_kernel_refuses_what_it_does_not_take():
    from quickvc_tpu_torch.ops import int8_mm

    a = torch.zeros(4, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        int8_mm.mm_kernel(a, a.T.contiguous())
    with pytest.raises(RuntimeError, match="mm has no backward"):
        int8_mm.mm(a.float().requires_grad_(), a.float().T)


@pytest.mark.parametrize("m,n,tile,blocks", [
    (16384, 3072, "128x256", 132), (16384, 3072, "128x128", 132),   # the probe's shape
    (1000, 264, "128x256", 132), (1000, 264, "128x128", 5),         # ragged M and N
    (200, 72, "128x256", 132), (130, 8, "128x128", 3),              # N under one tile
    (40000, 3072, "128x256", 132),                                  # a last group of 9 rows
])
def test_tile_schedule_covers_every_tile_once(m, n, tile, blocks):
    from quickvc_tpu_torch.ops import int8_mm

    bm, bn = (int(x) for x in tile.split("x"))
    sched = int8_mm.tile_schedule(m, n, tile, blocks)
    tiles = [o for block in sched for o in block]
    want = {(r, c) for r in range(0, m, bm) for c in range(0, n, bn)}
    assert len(tiles) == len(want) and set(tiles) == want
    assert len(sched) == min(blocks, len(want))
    # the tiles of one wave (the i-th of every block) lie in at most two
    # groups of GROUP_M tile rows: they share B's columns
    wave = {o[0] // (bm * int8_mm.GROUP_M) for block in sched for o in block[:1]}
    assert len(wave) <= 2
