"""Kernel layer: the CUDA build (``build.py``) and the kernel wrappers
(``cuda/``), each beside its plain PyTorch version."""
