"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it.  Building happens on first use (``kernels.build``),
never at import."""
