"""Featurization and synthesis DSP: plain PyTorch versions of kernels K1 and K3."""
