"""PyTorch port as a package: it imports no JAX, and nothing falls back to
the CPU quietly (a CUDA request without a card raises; a kernel entry point
refuses CPU tensors instead of running the plain version).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_cli_cuda_without_card_raises(tmp_path):
    """The default --device cuda never falls back to the CPU."""
    from quickvc_tpu_torch import convert

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert.main(["--outdir", str(tmp_path / "out")])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import neither JAX nor
    quickvc_tpu, nor tensorboard, tensorboardX, matplotlib, protobuf, soundfile,
    ml_dtypes or msgpack (the card's machine has neither ml_dtypes nor msgpack:
    bf16 rides as uint16 bits, and the .msgpack parameter files are decoded
    and written in pure Python, the exporter included)."""
    code = """
import importlib, pkgutil, runpy, sys
import quickvc_tpu_torch
for m in pkgutil.walk_packages(quickvc_tpu_torch.__path__, "quickvc_tpu_torch."):
    importlib.import_module(m.name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke")
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "quickvc_tpu",
                                                     "tensorboard", "tensorboardX", "matplotlib",
                                                     "soundfile", "ml_dtypes", "msgpack")
       or n.startswith("google.protobuf")]
new = ["quickvc_tpu_torch." + m for m in ("infer.streaming", "infer.realtime", "ops.int8_mm",
                                         "scripts.int8_matmul_probe", "scripts.realtime_bench",
                                         "data.native", "utils.msgpack_params", "dsp.pqmf",
                                         "downsample", "parallel.mesh", "parallel.shard_step",
                                         "parallel.tp", "parallel.tp_layers", "utils.profiling",
                                         "scripts.export_params")]
bad += [m + " not imported" for m in new if m not in sys.modules]
print(len([n for n in sys.modules if n.startswith("quickvc_tpu_torch.")]), bad)
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_importing_the_decoders_builds_and_loads_nothing():
    """Importing the native audio binding, the .msgpack reader and every module
    that uses them starts no compiler and loads no shared library."""
    code = """
import ctypes, subprocess
import numpy, scipy.io.wavfile, torch   # their own imports probe the machine
def refuse(*a, **k):
    raise AssertionError(f"called at import: {a[:1]}")
subprocess.run = subprocess.Popen = ctypes.CDLL = refuse
import quickvc_tpu_torch.data.native as native
import quickvc_tpu_torch.utils.msgpack_params
import quickvc_tpu_torch.data.audio_io, quickvc_tpu_torch.data.dataset
import quickvc_tpu_torch.downsample, quickvc_tpu_torch.utils.weights
assert native._lib is None
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_kernel_build_dir(tmp_path, monkeypatch):
    """A checkout builds into its own build/; an installed copy into the user's cache."""
    from quickvc_tpu_torch.ops import _cuda

    assert _cuda.build_dir() == REPO / "build" / "quickvc_tpu_torch"
    installed = tmp_path / "site-packages" / "quickvc_tpu_torch" / "ops" / "_cuda.py"
    monkeypatch.setattr(_cuda, "__file__", str(installed))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _cuda.build_dir() == tmp_path / "cache" / "quickvc_tpu_torch"


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel entry point never runs a plain version: a CPU tensor is an error."""
    from quickvc_tpu_torch.models.hubert import TransformerLayer
    from quickvc_tpu_torch.ops import (fused_attention, fused_disc_conv, fused_extractor,
                                       fused_istft, fused_mel, fused_transformer, int8_mm)

    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention.attention_packed_kernel(x, x, x, 1, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mel.wave_to_mel_kernel(torch.zeros(1, 3200), 16000, 1280, 320, 1280, 80)
    with pytest.raises(ValueError, match="CUDA"):
        fused_istft.polar_inverse_stft_kernel(torch.zeros(1, 8, 9), torch.zeros(1, 8, 9), 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mel.wave_to_spec_halo_kernel(torch.zeros(1, 3200), 1280, 320, 1280)
    k = torch.zeros(5, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_disc_conv.conv5_lrelu_kernel(x, k, None, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        fused_disc_conv.conv5_dw_kernel(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_extractor.extractor_front_kernel(torch.zeros(1, 3200), torch.zeros(8, 1, 10),
                                               torch.ones(8), torch.zeros(8),
                                               torch.zeros(8, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        fused_transformer.transformer_layer_kernel(x, TransformerLayer(64, 1, 128))
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention.attention_kernel(x[None], x[None], x[None], 0.125)
    xa = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention.attention_packed_aligned_kernel(xa, xa, xa, 1, 0.125)
    a8 = torch.zeros(64, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        int8_mm.mm_kernel(a8, a8)


def test_kernel_times_runs_on_the_cpu(capsys):
    """scripts/kernel_times.py (the parent/change A/B timer) runs through the
    dispatchers, so on the CPU it times their plain versions, with no
    device time, and prints its one JSON line."""
    from quickvc_tpu_torch.scripts import kernel_times

    out = kernel_times.main(["--device", "cpu", "--iters", "1", "--warmup", "0"])
    names = {"K1", "K1_library", "K1_2048", "K1_800", "K1_4096", "K2", "K10", "sdpa_64", "K9",
             "sdpa_128", "K3", "K3_stream", "K3_live64_1601", "K3_live64_1361", "K3_live1",
             "K8"}
    assert set(out) == names | {"package"}
    assert all(out[n] > 0 for n in names)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("kernel_times ") and json.loads(line.split(" ", 1)[1]) == out
