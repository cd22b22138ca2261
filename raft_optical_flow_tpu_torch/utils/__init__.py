"""Utilities: weight loading from the JAX package's flax `.npz` checkpoints."""
