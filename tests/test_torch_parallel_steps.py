"""Every step kind of the port at 2 processes against 1 process (CPU, gloo).

One launch of `tests/torch_dist_worker.py` (job kinds) per topology runs
every `FlowTrainer.STEP_FNS` kind and the RAFT step (RAFT-small with
dropout 0.25 and input noise: both draw over the batch axis) for one step
on a batch of 4 (families 64x96, UFlow 48x64 with the self-supervision on
from the first step, RAFT 64x64), from seeded weights; each process of
the 2-process run seeds its model and generator differently, and the
trainers start it from process 0's. The 2-process step must be the
1-process step: loss, metrics and `grad_norm` rel 1e-5 / abs 1e-6 (the JAX
package's `tests/test_multiprocess.py`), the updated parameters and
BatchNorm statistics within the statistical bound of its
`tests/test_cli_multiprocess.py` (max |d| < 1e-3, fewer than 1% of the
elements off by more than 1e-6: AdamW's first update is about lr *
sign(gradient)), the step generator's state equal, and every replicated
value equal on both processes.
"""

import numpy as np
import pytest

import torch_dist_worker as worker

KINDS = worker.FLOW_KINDS + ("raft",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("kinds")
    procs = worker.launch("kinds", 1, d) + worker.launch("kinds", 2, d)
    worker.wait(procs)
    return worker.results("kinds", 1, d)[0], worker.results("kinds", 2, d)


@pytest.mark.parametrize("kind", KINDS)
def test_two_processes_take_the_one_process_step(runs, kind):
    ref, (r0, r1) = runs
    keys = [k for k in ref if k.startswith(f"{kind}:")]
    assert keys and all(np.array_equal(r0[k], r1[k]) for k in keys), "processes disagree"
    metrics = [k for k in keys if ":metric:" in k]
    assert {k.split(":")[-1] for k in metrics} >= {"loss", "grad_norm"}
    for k in metrics:
        assert float(r0[k]) == pytest.approx(float(ref[k]), rel=1e-5, abs=1e-6), k
    assert float(ref[f"{kind}:metric:grad_norm"]) > 0
    variables = [k for k in keys if ":var:" in k]
    d = np.concatenate([np.abs(r0[k].astype(np.float64) - ref[k]).ravel() for k in variables])
    assert d.max() < 1e-3, f"max diff {d.max():.2e}"
    assert (d > 1e-6).mean() < 0.01, f"{(d > 1e-6).mean():.2%} of the parameters differ"
    assert np.array_equal(r0[f"{kind}:generator"], ref[f"{kind}:generator"])


def test_batch_norm_kinds_update_their_statistics(runs):
    """SimpleFlowNet's BatchNorms train: their running statistics moved, and
    the 2-process ones are the global batch's (held above)."""
    ref, _ = runs
    for kind in ("simple_flow", "simple_flow_unsup"):
        stats = [k for k in ref if k.startswith(f"{kind}:var:batch_stats/")]
        assert stats and any(np.abs(ref[k] - (k.endswith("var"))).max() > 1e-3 for k in stats)


@pytest.mark.parametrize("draw", ["crop", "offsets", "shift", "shifts"])
def test_uflow_draws_are_the_global_draws_sliced(runs, draw):
    ref, (r0, r1) = runs
    k = f"draw:{draw}"
    assert np.array_equal(np.concatenate([r0[k], r1[k]]), ref[k])
    assert not np.array_equal(r0[k], r1[k])
