"""Neuron recurrences: plain PyTorch scan cells and the fused CUDA cells."""
