"""The bf16 training step's gradient gate of ``chip_smoke.py`` on other draws.

    python -m quickvc_tpu_torch.scripts.bf16_step_gate [--seeds 1 2 3 4 5] [--device cuda]
        [--card-lstm kernel|cudnn|recurrence|f32]

``chip_smoke.py:check_train_step_against_cpu`` holds one bf16 step on the
card against the same step on the CPU: each gradient's max-norm relative
error ``maxrel(card, cpu)`` within ``max(2 maxrel(cpu, cpu_f32), 2e-2)``.
This probe runs that step (its small config, weights, compact batch and
draws; the batch from numpy seed s) for each seed, prints one JSON line a
seed with the worst tensor of D and of G and its error over its bound, and,
for each worst tensor, how far each side's bf16 gradient is from the
gradient of the same step in float64 on the CPU (``maxrel`` against it, and
the float32 steps' too). It changes nothing in the gate.

Then, to attribute the card's side, one bf16 convolution weight gradient
alone (``torch.nn.grad.conv1d_weight`` on bf16 tensors: cuDNN on the card)
at a few of the small config's conv shapes, against float64 on the same
bf16 inputs, beside the error of that float64 gradient rounded to bf16
once (what the CPU path and the JAX step compute): one ``bf16_wgrad``
line a shape.

``--card-lstm`` picks how the card runs the speaker LSTM at bf16 in this
probe: ``kernel`` (the default and the port's path, ``models/encoders.py``:
the JAX recurrence in the hand-written kernels of
``ops/lstm_recurrence.py``, every layer's forward in one launch and its
backward in another), ``recurrence`` (the same recurrence in its plain
step-by-step versions, the plain stack forward and backward, on the card), ``cudnn`` (cuDNN's bf16 LSTM on
bf16 weight copies, the path before the kernels) or ``f32`` (cuDNN's
float32 LSTM on the bf16 mel, its output cast back to bf16), to attribute
the card's side.

The float64 step runs the port's float32 path with every module, input,
``Tensor.float()`` and table of the plain iSTFT head in float64 (the K4
dispatcher, which takes float32 only, replaced by its plain version). ``--device cpu`` leaves out the card
side.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import warnings

import numpy as np
import torch

SR = 16000
FRAMES = 16
LOSSES = ("loss/d/total", "loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/kl", "loss/g/total")


def small(precision: str):
    """``chip_smoke.py:check_train_step_against_cpu``'s config."""
    from quickvc_tpu_torch.config import config_from_dict

    return config_from_dict({
        "train": {"segment_size": 2560, "max_speclen": 32, "precision": precision,
                  "learning_rate": 1e-4, "disc_width": 0.25, "batch_size": 2},
        "model": {"inter_channels": 16, "hidden_channels": 16,
                  "upsample_initial_channel": 32, "gin_channels": 16,
                  "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
                  "enc_wn_layers": 2, "flow_wn_layers": 2, "n_flows": 2}})


def voice(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """``chip_smoke.py:synth_voice``: harmonics of a wandering f0 under
    syllable-rate envelopes, breath noise, quiet lead-in and lead-out."""
    n = int(seconds * SR)
    tt = np.arange(n) / SR
    f0 = rng.uniform(90, 220) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * tt))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 12))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * tt) + 0.3, 0, None)
    x = x * env + 0.02 * rng.standard_normal(n)
    lead = int(0.2 * SR)
    x[:lead] *= 1e-3
    x[-lead:] *= 1e-3
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


def draws(seed: int) -> tuple[dict, torch.Tensor]:
    rng = np.random.default_rng(seed)
    wave = np.stack([voice(1.0, rng)[: FRAMES * 320 + 960] for _ in range(2)])
    batch = {"unit": torch.from_numpy(rng.standard_normal((2, FRAMES, 256)).astype(np.float32)),
             "wave_s16": torch.from_numpy(np.round(wave * 32767).astype(np.int16)),
             "n_take": torch.tensor([FRAMES, FRAMES - 5], dtype=torch.int32)}
    eps_q = torch.from_numpy(rng.standard_normal((2, 16, FRAMES)).astype(np.float32))
    return batch, eps_q.bfloat16().float()


@contextlib.contextmanager
def float64_step():
    """The float32 path in float64: ``Tensor.float``, the step's compute
    dtype and the plain iSTFT head's tables give float64, the step's K4
    dispatcher its plain version."""
    from quickvc_tpu_torch.dsp import istft, stft
    from quickvc_tpu_torch.train import step

    saved = (torch.Tensor.float, step.wave_to_spec_halo, dict(step.DTYPES),
             istft._inverse_dft_matrices, istft._ola_envelope)
    torch.Tensor.float = lambda self, *a, **k: self.double()
    step.wave_to_spec_halo = stft.wave_to_spec_halo
    step.DTYPES["f32"] = torch.float64
    istft._inverse_dft_matrices = lambda *a: [b.astype(np.float64)
                                              for b in saved[3](*a)]
    istft._ola_envelope = lambda *a: saved[4](*a).astype(np.float64)
    try:
        yield
    finally:
        torch.Tensor.float, step.wave_to_spec_halo = saved[:2]
        step.DTYPES.update(saved[2])
        istft._inverse_dft_matrices, istft._ola_envelope = saved[3:]


def run(cfg, base, batch, eps_q, dev: torch.device, f64: bool = False) -> dict:
    from quickvc_tpu_torch.train.state import create_train_state
    from quickvc_tpu_torch.train.step import mel_basis, train_step

    net_g, net_d = copy.deepcopy(base.net_g), copy.deepcopy(base.net_d)
    if f64:
        net_g, net_d = net_g.double(), net_d.double()
    state = create_train_state(cfg, dev, net_g, net_d)
    basis = mel_basis(cfg, dev)
    ctx = float64_step() if f64 else contextlib.nullcontext()
    with ctx, torch.backends.mkldnn.flags(enabled=False):
        out = train_step(state, {k: v.to(dev) for k, v in batch.items()},
                         basis.double() if f64 else basis,
                         eps_q=(eps_q.double() if f64 else eps_q).to(dev),
                         ids_slice=torch.tensor([3, 8]), debug_grads=True)
    return {"losses": {k: float(out[k]) for k in LOSSES},
            "d": {k: v.detach().cpu().double() for k, v in out["debug/d_grads"].items()},
            "g": {k: v.detach().cpu().double() for k, v in out["debug/g_grads"].items()}}


def maxrel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-6))


def cudnn_recurrence(encoder, x: torch.Tensor) -> torch.Tensor:
    """The last layer's final ``h`` (B, H) of ``encoder``'s LSTM from cuDNN's
    LSTM in ``x``'s dtype, on the weights cast and the biases summed as the
    port's bf16 path takes them (``SpeakerEncoder._layer_weights``): the
    card's path before the recurrence kernels, ``--card-lstm cudnn``."""
    lstm = encoder.lstm
    weights = []
    for layer in range(lstm.num_layers):
        w_ih, w_hh, b = encoder._layer_weights(layer, x.dtype)
        weights += [w_ih, w_hh, b, torch.zeros_like(b)]
    h0 = x.new_zeros(lstm.num_layers, x.shape[0], lstm.hidden_size)
    with warnings.catch_warnings():   # the copies are not one flat buffer: cuDNN packs them
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        _, h, _ = torch.lstm(x, (h0, h0), weights, True, lstm.num_layers, 0.0,
                             encoder.training, False, True)
    return h[-1]


@contextlib.contextmanager
def card_lstm(mode: str):
    """The speaker LSTM's bf16 path on the card, as ``--card-lstm`` picks it."""
    from quickvc_tpu_torch.models.encoders import SpeakerEncoder
    from quickvc_tpu_torch.ops import lstm_recurrence as lr

    saved = (SpeakerEncoder._recurrence, lr.lstm_stack_kernel, lr.lstm_forward_kernel,
             lr.lstm_backward_kernel, lr.lstm_stack_backward_kernel)
    if mode == "recurrence":
        lr.lstm_stack_kernel = lr.lstm_stack_reference
        lr.lstm_forward_kernel = lr.lstm_forward_reference
        lr.lstm_backward_kernel = lr.lstm_backward_reference
        lr.lstm_stack_backward_kernel = lr.lstm_stack_backward_reference
    elif mode == "cudnn":
        SpeakerEncoder._recurrence = cudnn_recurrence
    elif mode == "f32":
        SpeakerEncoder._recurrence = lambda self, x: self.lstm(x.float())[1][0][-1].to(x.dtype)
    try:
        yield
    finally:
        (SpeakerEncoder._recurrence, lr.lstm_stack_kernel, lr.lstm_forward_kernel,
         lr.lstm_backward_kernel, lr.lstm_stack_backward_kernel) = saved


def probe(seed: int, device: str, lstm: str = "kernel") -> dict:
    from quickvc_tpu_torch.train.state import create_train_state

    batch, eps_q = draws(seed)
    base = create_train_state(small("f32"), torch.device("cpu"))
    cpu = torch.device("cpu")
    runs = {"cpu_f32": run(small("f32"), base, batch, eps_q, cpu),
            "cpu_bf16": run(small("bf16"), base, batch, eps_q, cpu),
            "cpu_f64": run(small("f32"), base, batch, eps_q, cpu, f64=True)}
    if device == "cuda":
        runs["card_f32"] = run(small("f32"), base, batch, eps_q, torch.device("cuda"))
        with card_lstm(lstm):
            runs["card_bf16"] = run(small("bf16"), base, batch, eps_q, torch.device("cuda"))
    out = {"seed": seed, "card_lstm": lstm}
    for which in ("d", "g"):
        exact = runs["cpu_f64"][which]
        ratios = {}
        if device == "cuda":
            for k, r in runs["cpu_bf16"][which].items():
                bound = max(2 * maxrel(r, runs["cpu_f32"][which][k]), 2e-2)
                ratios[k] = maxrel(runs["card_bf16"][which][k], r) / bound
        worst = max(ratios, key=ratios.get) if ratios else None
        tensors = [worst] if worst else []
        out[which] = {"worst": worst, "worst_err_over_bound": ratios.get(worst),
                      "over_1": sorted(k for k, v in ratios.items() if v > 1),
                      "from_f64": {k: {side: maxrel(run_[which][k], exact[k])
                                       for side, run_ in runs.items() if side != "cpu_f64"}
                                   for k in tensors},
                      "cpu_f32_from_f64_max": max(maxrel(runs["cpu_f32"][which][k], v)
                                                  for k, v in exact.items())}
    return out


# (batch, in channels, length, out channels, kernel, dilation): the flow's and
# posterior encoder's WaveNet convs (16 hidden, kernel 5, 16 frames) and the
# decoder's resblock convs at their upsampled lengths
WGRAD_SHAPES = ((2, 16, 16, 32, 5, 1), (2, 16, 16, 32, 5, 2), (2, 16, 640, 16, 3, 5),
                (2, 8, 2560, 8, 3, 1))


def wgrad_check(device: torch.device) -> list[dict]:
    lines = []
    for i, (n, c_in, length, c_out, k, dil) in enumerate(WGRAD_SHAPES):
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(n, c_in, length, generator=g).bfloat16()
        dy = torch.randn(n, c_out, length, generator=g).bfloat16()
        pad = dil * (k - 1) // 2
        exact = torch.nn.grad.conv1d_weight(x.double(), (c_out, c_in, k), dy.double(),
                                            padding=pad, dilation=dil)
        ours = torch.nn.grad.conv1d_weight(x.to(device), (c_out, c_in, k), dy.to(device),
                                           padding=pad, dilation=dil)
        line = {"shape": [n, c_in, length, c_out, k, dil], "dtype": str(ours.dtype),
                "maxrel_from_f64": maxrel(ours.cpu().double(), exact),
                "rounded_once_maxrel_from_f64": maxrel(exact.bfloat16().double(), exact)}
        print("bf16_wgrad " + json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--card-lstm", default="kernel",
                   choices=("kernel", "cudnn", "recurrence", "f32"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bf16_step_gate: no CUDA card (use --device cpu for the CPU side)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    for seed in args.seeds:
        lines.append(probe(seed, args.device, args.card_lstm))
        print("bf16_step_gate " + json.dumps(lines[-1]), flush=True)
    if args.device == "cuda":
        lines += wgrad_check(torch.device("cuda"))
    return lines


if __name__ == "__main__":
    main()
