"""The port's benchmark: one cell of BENCHMARK.json run once (`run.py`)."""
