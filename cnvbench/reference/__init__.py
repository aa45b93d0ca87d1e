"""Plain references of what the benchmark's cells compute, in NumPy and plain PyTorch.

They import nothing of the program, of JAX or of the JAX package, and take
nothing the program made: each works its tables (window weights, reference
means) out again from the benchmark's own inputs.
"""
