"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, Triton for
SubnetNorm), their plain PyTorch versions, the device-decided dispatcher
and the public entry points (ops.py)."""
