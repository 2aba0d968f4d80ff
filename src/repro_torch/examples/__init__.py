"""The reference's examples on the port: each is a ``main(n=...,
device="cuda", backend=None)`` that prints the reference script's table
and returns what it printed, runnable as ``python -m
repro_torch.examples.<name> [--device cpu]``."""
