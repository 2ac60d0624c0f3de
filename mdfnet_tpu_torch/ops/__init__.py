"""Tensor ops of the port: sampling, warp, fitting, regression, and the
hand-written CUDA kernels under ``ops.cuda``."""
