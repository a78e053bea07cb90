"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); it counts its launches in ``STATS``.
"""

from quickvc_tpu_torch.ops import fused_attention, fused_istft, fused_mel

KERNELS = {m.STATS.name: m.STATS for m in (fused_mel, fused_attention, fused_istft)}


def reset_launch_counts() -> None:
    for stats in KERNELS.values():
        stats.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: stats.launches for name, stats in KERNELS.items()}
