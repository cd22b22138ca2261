"""RAFT-small's UFlow step in the port against the JAX package's, on the CPU:
the slice as a whole (`FlowTrainer('raft_uflow_unsup')`, RAFT in training
mode through the lookup's CUDA wrappers, K1 and its backward K3, which run
their plain versions on CPU tensors; the UFlow losses, SMURF's sequence
weighting, the teacher-student self-supervision and the optimizer step).

`check_step` of tests/test_torch_families_grad.py with JAX in fp32, at
`checkpoints/raft_small.npz` (at JAX-initialized random weights RAFT-small
sits on a discontinuity: ROADMAP.md "Gradient comparisons"), batch 2, 48x64
crops of the golden's real frames (`utils/grad_check.py::uflow_check_batch`),
2 iterations, the wang occlusion masks on from step 0 and the train state
at step 200, so that the self-supervision weight is half of its 0.3: the
loss and every term (census, smooth2, selfsup, epe, `grad_norm`) within rel
1e-5 and each layer's gradient within 2e-5 of JAX's. JAX's RAFT does not
run in float64 (its scan carries fp32), so the port's step in float64 is
the yardstick: JAX's fp32 lies further from it than the port's fp32 does
(selfsup 2.1e-5 against 7.2e-6; the worst layers 7.4e-5 against 1.9e-5),
and an entry past its bound passes only where that reading holds and
within 2x JAX's own floor, taken under a change of the weights or of the
frames (`frame_floor`: the self-supervision term, its teacher and student
flows nearly cancelling, reads 1.41e-5 against JAX with a floor of
1.07e-5).
"""

import os

import torch

from raft_optical_flow_tpu.models.raft import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu_torch.models import RAFTConfig
from raft_optical_flow_tpu_torch.utils.grad_check import uflow_check_batch
from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint
from test_torch_families_grad import check_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_uflow_step_matches_jax():
    variables = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    check_step("raft_uflow_unsup", variables, uflow_check_batch(REPO), JaxRAFTConfig(small=True),
               RAFTConfig(small=True), x64=False,
               step_kwargs=dict(iters=2, occlusion_warmup_steps=0), step=200, frame_floor=True,
               float64_config=RAFTConfig(small=True, corr_impl="plain",
                                         compute_dtype=torch.float64))
