"""Data-parallel training across processes, one process per card.

Port of ``quickvc_tpu/parallel/`` (``mesh.py``, ``shard_step.py``) and of
what the JAX trainer does when it runs in more than one process: the
process group and the ZeRO-1 partition of the AdamW moments
(:mod:`quickvc_tpu_torch.parallel.mesh`), the gradient and scalar reductions
of the explicit-collective step and each rank's seed
(:mod:`quickvc_tpu_torch.parallel.shard_step`). The collectives are NCCL's
on the card and gloo's on the CPU, through ``torch.distributed``.
"""
