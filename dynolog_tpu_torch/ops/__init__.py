"""Compute kernels of the flagship workload, hand-written in CUDA for
Hopper (csrc/), each with a plain PyTorch version beside it.

Importing this package builds nothing: the kernels are compiled with nvcc
at their first launch (ops._build).
"""

from dynolog_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]
