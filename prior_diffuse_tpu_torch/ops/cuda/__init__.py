"""Kernel wrappers: on a CUDA tensor each launches its hand-written kernel
(or raises); on a CPU tensor it runs the kernel's plain PyTorch version."""
