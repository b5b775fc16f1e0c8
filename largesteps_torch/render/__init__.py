"""Differentiable multi-view rendering on per-tile CUDA kernels."""
