"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, built, bound and launched through `library.py`. Kernels build at
first use, never at import."""
