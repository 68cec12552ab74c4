"""PyTorch / CUDA port of the LazyBatching serving system for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it imports torch and
never JAX, and nothing of ``repro`` — the scheduling layer it needs is kept
as its own copy. Kernels are hand-written for ``sm_90a`` (CUDA C++ built
with ``nvcc`` at first use), each beside a plain PyTorch version that CPU
tensors take.
"""
