"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version (see ``_build`` for how they are compiled and loaded)."""
