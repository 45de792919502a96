"""Attention ops of the port, each a hand-written CUDA kernel with its
plain PyTorch version beside it."""
