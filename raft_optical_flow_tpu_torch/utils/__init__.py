"""Utilities: weight loading from the JAX package's flax `.npz` checkpoints
(`weights`), reference PyTorch checkpoints converted straight into the port
(`torch_convert`), train-state checkpoints (`checkpoint`), the per-layer
gradient comparisons of a train step (`grad_check`) and the kernels'
gradient-parity gate (`grad_parity`), `torch.export` programs (`export`),
timing and memory (`profiling`), TensorBoard event files and flow grids
(`logging`), and the flow visualizations (`flow_viz`)."""
