"""Typed configuration (the port's own copy of ``quickvc_tpu/config.py``).

Reads the same JSON as the JAX package (``configs/quickvc.json``) and the
reference's ``logs/quickvc/config.json``. Unknown and legacy keys (``ssl_dim``,
``use_sr``, ``n_layers_q`` ...) are accepted and ignored, like the
reference's ``**kwargs`` shim (reference ``models.py:568-575``). Fields that
only the JAX package reads are kept so that one file configures both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


def _filter_kwargs(cls, d: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class TrainConfig:
    """Training hyperparameters (reference ``utils.py:20-38``) and the JAX
    trainer's fields. The port's trainer reads every JAX field but two:
    ``num_hosts``, which no JAX module reads either (the launcher's
    ``WORLD_SIZE`` sets the number of processes), and ``data_axis``, the
    name of JAX's mesh axis."""

    log_interval: int = 20
    eval_interval: int = 1000
    seed: int = 1234
    epochs: int = 20000
    learning_rate: float = 2e-4
    betas: tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 32
    fp16_run: bool = False
    lr_decay: float = 0.999875
    segment_size: int = 10240
    c_mel: float = 45.0
    c_kl: float = 1.0
    max_speclen: int = 512
    fft_sizes: tuple[int, ...] = (384, 683, 171)
    hop_sizes: tuple[int, ...] = (30, 60, 10)
    win_lengths: tuple[int, ...] = (150, 300, 60)
    window: str = "hann_window"
    # Fields of the JAX trainer (quickvc_tpu/config.py documents them)
    precision: str = "bf16"
    num_hosts: int = 1
    data_axis: str = "data"
    disc_width: float = 1.0
    loader_workers: int = 8
    loader_mode: str = "thread"
    grad_reduce_dtype: str = "f32"
    guard_nonfinite: bool = True
    guard_loss_max: float = 65504.0
    split_prior: bool = False
    prefetch_batches: int = 2
    transfer: str = "compact"
    zero_opt_state: bool = False
    ckpt_max_to_keep: int = 5
    max_host_rss_gb: float = 0.0
    export_torch_every: int = 0

    def __post_init__(self):
        checks = (("grad_reduce_dtype", ("f32", "bf16")),
                  ("precision", ("f32", "bf16")),
                  ("transfer", ("full", "compact")),
                  ("loader_mode", ("thread", "process")))
        for name, allowed in checks:
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: must be one "
                                 f"of {allowed}")
        if self.zero_opt_state and self.grad_reduce_dtype != "f32":
            raise ValueError("zero_opt_state requires grad_reduce_dtype='f32'")


@dataclass
class DataConfig:
    """Data/featurization hyperparameters (reference ``utils.py:41-51``)."""

    training_files: str = "./dataset/train.txt"
    validation_files: str = "./dataset/test.txt"
    adress_data_root: str = ""
    sampling_rate: int = 16000
    filter_length: int = 1280       # STFT n_fft
    hop_length: int = 320
    win_length: int = 1280
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float | None = None


@dataclass
class ModelConfig:
    """Model hyperparameters (reference ``utils.py:54-68``)."""

    ms_istft_vits: bool = True
    mb_istft_vits: bool = False
    istft_vits: bool = False
    subbands: int = 4
    gen_istft_n_fft: int = 16
    gen_istft_hop_size: int = 4
    inter_channels: int = 192
    hidden_channels: int = 192
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: tuple[int, ...] = (5, 4)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: tuple[int, ...] = (16, 16)
    gin_channels: int = 256
    unit_channels: int = 256        # HuBERT-soft unit dim (reference models.py:579)
    enc_wn_layers: int = 16         # reference hardcodes 16/4/4 (models.py:582-584)
    flow_wn_layers: int = 4
    n_flows: int = 4
    use_pallas_istft: bool = False  # read by the JAX package only

    @property
    def decoder_kind(self) -> str:
        if self.mb_istft_vits:
            return "mb_istft"
        if self.ms_istft_vits:
            return "ms_istft"
        if self.istft_vits:
            return "istft"
        raise ValueError("No decoder flag set (reference models.py:588-589)")


@dataclass
class QuickVCConfig:
    """Root config (reference ``utils.py:71-75``)."""

    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    model_dir: str = "./logs/quickvc"

    @property
    def spec_channels(self) -> int:
        return self.data.filter_length // 2 + 1

    @property
    def segment_frames(self) -> int:
        return self.train.segment_size // self.data.hop_length

    def to_dict(self) -> dict[str, Any]:
        def conv(x):
            if dataclasses.is_dataclass(x):
                return {f.name: conv(getattr(x, f.name)) for f in dataclasses.fields(x)}
            if isinstance(x, (list, tuple)):
                return [conv(v) for v in x]
            return x
        return conv(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def _tupleize(x):
    if isinstance(x, list):
        return tuple(_tupleize(v) for v in x)
    return x


def config_from_dict(d: dict[str, Any]) -> QuickVCConfig:
    train = TrainConfig(**{k: _tupleize(v) for k, v in
                           _filter_kwargs(TrainConfig, d.get("train", {})).items()})
    data = DataConfig(**_filter_kwargs(DataConfig, d.get("data", {})))
    model = ModelConfig(**{k: _tupleize(v) for k, v in
                           _filter_kwargs(ModelConfig, d.get("model", {})).items()})
    return QuickVCConfig(train=train, data=data, model=model,
                         model_dir=d.get("model_dir", "./logs/quickvc"))


def load_config(path: str) -> QuickVCConfig:
    """Load a QuickVC JSON config (accepts both new and reference schemas)."""
    with open(path) as f:
        return config_from_dict(json.load(f))


def get_config(config_path: str, model_name: str = "quickvc",
               model_root: str = "./logs") -> QuickVCConfig:
    """Load a config for a training run: ``model_dir = model_root/model_name``,
    created, with the resolved config archived there as ``config.json``
    (reference ``utils.get_hparams``)."""
    cfg = load_config(config_path)
    cfg.model_dir = os.path.join(model_root, model_name)
    os.makedirs(cfg.model_dir, exist_ok=True)
    cfg.save(os.path.join(cfg.model_dir, "config.json"))
    return cfg
