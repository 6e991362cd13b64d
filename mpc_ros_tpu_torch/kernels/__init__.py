"""Hand-written CUDA kernels (`csrc/`), their plain PyTorch versions and
the build that compiles them at first use."""
