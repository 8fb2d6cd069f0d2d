"""PyTorch/CUDA port of the reference JAX package (``repro``), slice by
slice. Slice 1: continuous-batching serving of sigma-MoE language models
(the grouped CVMM GEMM and the row gather as CUDA kernels). Slice 2:
training the paper's Transformer-XL sigma-MoE language model, whose expert
MLP runs forward and backward on the fused gather-GEMM, gate-epilogue GEMM
and expert weight-gradient kernels. Every TPU kernel on these paths is a
hand-written CUDA kernel for Hopper (``kernels/csrc``).

The port imports torch and numpy, never jax and nothing of ``repro``.
Module names mirror ``src/repro/``.
"""
