"""Model substrate in PyTorch: attention and FFN blocks, the layer-walking
backbone and the LM step functions (dense attention LMs for now)."""
