"""Attention dispatch and the hand-written CUDA kernels of the port."""
