"""Benchmarks of the port (counterparts of the reference's
``benchmarks/``): :mod:`.kernel_bench`."""
