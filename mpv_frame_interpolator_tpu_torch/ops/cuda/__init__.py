"""The port's hand-written Hopper kernels: one module per kernel, each
holding the kernel's wrapper, its plain PyTorch version and its launch
counts.  The CUDA sources are in the package's csrc/; _build.py compiles
them with nvcc at first use and loads them with ctypes."""
