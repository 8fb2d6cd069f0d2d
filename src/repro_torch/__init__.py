"""PyTorch/CUDA port of the reference JAX package (``repro``), slice by
slice. Slice 1: continuous-batching serving of sigma-MoE language models,
whose two TPU kernels on that path (the grouped CVMM GEMM and the row
gather) are hand-written CUDA kernels for Hopper (``kernels/csrc``).

The port imports torch and numpy, never jax and nothing of ``repro``.
Module names mirror ``src/repro/``.
"""
