"""Utilities: weight loading from the JAX package's flax `.npz` checkpoints
(`weights`), train-state checkpoints (`checkpoint`), the per-layer
gradient comparisons of a train step (`grad_check`), and the flow
visualizations (`flow_viz`)."""
