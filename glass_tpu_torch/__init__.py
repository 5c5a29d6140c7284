"""glass_tpu_torch: the PyTorch/CUDA port of glass_tpu for NVIDIA Hopper.

A second package beside ``glass_tpu`` (the JAX reference, which it never
imports).  Plain tensor code is PyTorch; each of glass_tpu's Pallas TPU
kernels is a CUDA kernel written for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use and launched through ``ctypes``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, where every kernel is
replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
