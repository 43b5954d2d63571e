"""Hand-written Hopper kernels and their plain PyTorch versions.

Port of ``repro/kernels``.  Each kernel module holds the wrapper that
launches its CUDA kernel (``csrc/*.cu``, built by ``_build.py``), the plain
PyTorch version of the same function, and a launch counter.
"""
