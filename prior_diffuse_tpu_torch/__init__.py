"""Prior-DiffuSE on PyTorch + CUDA (NVIDIA Hopper).

The PyTorch counterpart of ``prior_diffuse_tpu``: the same modules under
the same paths, with the three Pallas kernels of the JAX package
rewritten as hand-written CUDA C++ kernels for ``sm_90a``
(``csrc/``, bound through ``ops/``).  This package imports torch and
numpy only; the JAX package is its numerical reference in the tests.

Layout convention (shared with the JAX package): complex spectra are
real-packed channels-last ``[B, T, F, 2]``, activations ``[B, T, F, C]``.
"""

__version__ = "0.1.0"
