"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, their gradients (autograd.py), the device-decided
dispatcher and the public entry points (ops.py)."""
