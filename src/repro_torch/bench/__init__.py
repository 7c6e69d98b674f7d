"""Port copies of the reference's model-only benchmarks (``benchmarks/``):
each prints the reference's CSV rows, ``name,us_per_call,derived``."""
