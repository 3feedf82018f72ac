"""Kernel layer: plain torch versions, Hopper CUDA kernels and the
device dispatcher."""
