"""Build and binding of the package's CUDA kernels (csrc/)."""
