"""Core numerics: sparse matrices, the system matrix, solvers, optimizers."""
