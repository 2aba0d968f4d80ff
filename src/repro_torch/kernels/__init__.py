"""Kernels of the port: float64 host mirrors (``ref``), plain PyTorch
versions and hand-written CUDA kernels (``segment_agg``, ``bin_agg``,
built by ``build``), behind the reference's op names (``ops``)."""
