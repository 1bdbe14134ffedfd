"""Adapter DP and packed-count kernels: plain torch versions beside the
hand-written CUDA kernels they are held against."""
