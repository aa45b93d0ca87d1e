"""Compute ops: plain PyTorch pipeline plus the hand-written CUDA kernels."""
