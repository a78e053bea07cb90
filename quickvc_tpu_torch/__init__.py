"""QuickVC in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``quickvc_tpu``, which stays the reference: each
module here mirrors its counterpart's path (``config``, ``data``, ``dsp``,
``ops``, ``models``, ``losses``, ``train``, ``utils``), imports neither JAX nor ``quickvc_tpu``, and
is held against it by the tests ``tests/test_torch_*.py``. Modules are
channels-first (B, C, T) and use the reference's ``state_dict`` keys.
"""
