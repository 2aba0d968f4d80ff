"""The port's benchmarks (counterparts of the top-level ``benchmarks/``):
B1-B9, run in order by ``python -m repro_torch.benchmarks.run``."""
