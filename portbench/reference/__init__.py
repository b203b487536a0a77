"""Plain PyTorch reference of what the benchmark's cells compute.

Imports neither `jax`, the JAX package, nor anything of the port: it works
out again, from the inputs the harness hands it, what the port derives.
"""
