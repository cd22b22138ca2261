"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Nothing here compiles or loads at import: the library is built by nvcc on the
first launch (`_build.py`).
"""
