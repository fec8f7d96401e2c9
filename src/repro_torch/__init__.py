"""SuperServe in PyTorch for NVIDIA Hopper: the port of the JAX package
``repro``. Same module names, same parameter trees, hand-written CUDA
kernels in place of the Pallas ones. Imports no JAX and nothing of
``repro``."""

__version__ = "0.1.0"
