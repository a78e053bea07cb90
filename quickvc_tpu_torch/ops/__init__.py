"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); it counts its launches in a
``KernelStats``.
"""

from quickvc_tpu_torch.ops import (fused_attention, fused_disc_conv, fused_extractor,
                                  fused_istft, fused_mel, fused_transformer, int8_mm,
                                  lstm_recurrence)

KERNELS = {s.name: s for s in (fused_mel.STATS, fused_attention.STATS, fused_istft.STATS,
                               fused_mel.SPEC_STATS, fused_disc_conv.STATS,
                               fused_disc_conv.DW_STATS, fused_extractor.STATS,
                               fused_transformer.STATS, fused_attention.ALIGNED_STATS,
                               fused_attention.HEADED_STATS, int8_mm.S8_STATS,
                               int8_mm.BF16_STATS, fused_attention.BF16_STATS,
                               fused_attention.ALIGNED_BF16_STATS,
                               fused_attention.HEADED_BF16_STATS, fused_extractor.BF16_STATS,
                               fused_transformer.BF16_STATS, fused_disc_conv.BF16_STATS,
                               fused_disc_conv.DW_BF16_STATS, fused_disc_conv.WGMMA_STATS,
                               fused_disc_conv.DW_WGMMA_STATS, fused_extractor.WGMMA_STATS,
                               lstm_recurrence.STATS, lstm_recurrence.BACKWARD_STATS)}


def reset_launch_counts() -> None:
    for stats in KERNELS.values():
        stats.reset()


def launch_counts() -> dict[str, int]:
    return {name: stats.launches for name, stats in KERNELS.items()}
