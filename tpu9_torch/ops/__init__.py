"""Ops of the port: plain PyTorch paths and the wrappers of the CUDA
kernels built from ``tpu9_torch/csrc``."""
