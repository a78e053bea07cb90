"""bfloat16 in numpy, which has no such dtype: float32 values as bf16 bit patterns.

The compact wire carries units in bf16 at ``train.precision: "bf16"``, as
the JAX loader does with ``ml_dtypes.bfloat16`` (``quickvc_tpu/data/
dataset.py:256-268``); the port holds the same bits in ``uint16`` arrays.
:func:`to_bits` rounds as ``ml_dtypes`` does: to nearest, ties to even,
overflow to infinity, and every NaN to the quiet NaN of its sign. The
trainer views the bits as ``torch.bfloat16`` after its copy to the device
(``train/loop.py:_upload``).
"""

from __future__ import annotations

import numpy as np


def to_bits(x: np.ndarray) -> np.ndarray:
    """float32 values (any shape) -> their bf16 bit patterns as ``uint16``."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    nan = ((u >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return np.where(np.isnan(u.view(np.float32)), nan, rounded).astype(np.uint16)
