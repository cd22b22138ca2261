"""PyTorch/CUDA port of `raft_optical_flow_tpu`, for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (`models/`, `ops/`, `kernels/`,
`utils/`) and module names, so each module has a counterpart there. It imports
torch and numpy only. Public tensors keep the JAX package's layouts: images
NHWC in [0, 255], coords and flow `[B, h, w, 2]` in (x, y), correlation
pyramid levels `[B, Q, Hl, Wl]`, lookup windows `[B, h, w, L*K^2]`.

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU. On the CPU every kernel wrapper runs its plain PyTorch version.
"""
