"""Model substrate in PyTorch: attention, FFN, MoE, Mamba2 and xLSTM blocks,
the layer-walking backbone and the LM step functions (token-frontend LMs)."""
