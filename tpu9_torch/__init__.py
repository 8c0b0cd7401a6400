"""tpu9_torch: the PyTorch/CUDA port of tpu9's compute layer.

The JAX package ``tpu9`` stays the reference; this package mirrors its
layout (``tpu9_torch/ops/attention.py`` is the counterpart of
``tpu9/ops/attention.py``, and so on) and imports nothing from it. Its Pallas
TPU kernels become CUDA kernels written for Hopper under ``csrc/``, each with
its plain-PyTorch twin in the same module as its wrapper.
"""
