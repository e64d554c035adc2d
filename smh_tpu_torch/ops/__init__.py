"""Device half of the port: the fused pass, the scales read, the CUDA kernels."""
