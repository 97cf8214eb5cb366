"""The benchmark's plain reference (``tracer.py``): plain PyTorch, no part
of the program, no JAX."""
