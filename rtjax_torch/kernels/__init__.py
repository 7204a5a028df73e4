"""Traversal kernels: hand-written CUDA for Hopper, with plain PyTorch
versions (the CPU path and the oracle on the card)."""
