"""The port's benchmarks (counterparts of the top-level ``benchmarks/``):
for now B3, the kernels bench. ``python -m repro_torch.benchmarks.run``."""
