"""PyTorch port of the partial adaptive indexing engine, for NVIDIA Hopper.

Mirrors :mod:`repro` file for file. The JAX package stays the reference;
this package imports ``torch`` and ``numpy`` only. Object data lives on
a CUDA device by default (``device="cuda"``) and the data-plane
reductions run as hand-written CUDA kernels (``repro_torch.kernels``);
tests ask for the CPU explicitly with ``device="cpu"`` and the
``"np"``/``"torch"`` backends.
"""
