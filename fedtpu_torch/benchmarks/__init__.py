"""Benchmarks of the port (``benchmarks/`` of the JAX package): the
whole-round mega-kernel against the composed round."""
