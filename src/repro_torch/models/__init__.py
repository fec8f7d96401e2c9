"""Model substrate in PyTorch: attention, FFN, MoE, Mamba2 and xLSTM blocks,
the layer-walking backbone and the LM step functions (token- and
embed-frontend LMs), and the paper's OFA-ResNet conv supernet."""
