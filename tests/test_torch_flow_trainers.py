"""The port's family trainers (`train/trainers.py`) and `cli/train_flow.py`
against the JAX package's, on the CPU.

  - `make_step_optimizer` against optax's chain on the SAME gradients (Adam's
    first update is about lr*sign(g), so gradients from two backward passes
    could flip near-zero signs): AdamW and Adam with the L2 term, the clip
    active and not, over counts on both sides of a StepLR boundary; the
    parameters within 1e-6, `grad_norm` and the schedule within rel 1e-6.
  - A weights file that `FlowTrainer.save_checkpoint` writes loads through the
    JAX package's `load_flax_checkpoint` as the flax tree of a JAX init (the
    golden's keys) and through the port's, BatchNorm statistics included.
  - `train_flow --synthetic` trains two steps on the CPU, writes its
    checkpoints and resumes; its synthetic batches are the JAX CLI's; an
    incomplete `--dist_*` request is refused (it never trains alone), and
    a dataset stage reads its root. The mesh path and `--dist_*` at two
    processes: tests/test_torch_parallel_steps.py and
    test_torch_parallel_cli.py.

One step of each of the seven kinds against the JAX package's step function
(`check_step` of tests/test_torch_families_grad.py) sits with its family:
lfn3 and lfn3_unsup in tests/test_torch_lfn3_grad.py, S+PseudoReg's lfn3 in
test_torch_lfn3_grad_s.py, simple_flow and simple_flow_unsup in
test_torch_simple_flow_grad.py, ifnet and ifnet_unsup in
test_torch_ifnet_grad.py, raft_uflow_unsup in
test_torch_flow_trainers_uflow.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_optical_flow_tpu.cli.train_flow import _synthetic_batches as jax_synthetic_batches
from raft_optical_flow_tpu.train.trainers import OptimConfig as JaxOptimConfig
from raft_optical_flow_tpu.train.trainers import make_step_optimizer as jax_make_step_optimizer
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.cli import train_flow
from raft_optical_flow_tpu_torch.models import SimpleFlowNet
from raft_optical_flow_tpu_torch.train.trainers import (
    FlowTrainer,
    OptimConfig,
    make_step_optimizer,
)
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, load_flax_checkpoint
from test_torch_families_grad import step_batch
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("adamw", [True, False])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip inactive / active
def test_step_optimizer_matches_optax_on_the_same_gradients(adamw, grad_scale):
    rng = np.random.RandomState(2)
    shapes = [(4, 3, 3, 3), (4,), (7,), (2, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-3, weight_decay=1e-2, adamw=adamw, step_size=3, lr_gamma=0.5)
    tx, ref_schedule = jax_make_step_optimizer(JaxOptimConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_step_optimizer(tp, OptimConfig(**kw))
    for count in range(7):  # counts 0..6: the lr halves at 3 and 6
        assert _rel(opt.schedule(count), ref_schedule(jnp.asarray(count, jnp.int32))) <= 1e-6
        grads = [(rng.randn(*s) * grad_scale).astype(np.float32) for s in shapes]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        ref_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
        assert _rel(norm, ref_norm) <= 1e-6
        for a, b in zip(tp, jp):
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-6, count
    assert opt.param_groups[0]["count"] == 7


def test_saved_weights_load_in_jax_and_in_the_port(tmp_path):
    """A step moves the BatchNorm statistics; the file holds them and the
    weights, in the golden's (a JAX init's) flax layout."""
    golden = os.path.join(GOLDENS, "simple_flow_params.npz")
    trainer = FlowTrainer("simple_flow", (64, 96), restore_variables=load_flax_checkpoint(golden),
                          checkpoint_dir=str(tmp_path), device="cpu")
    trainer.train_step(step_batch(3))
    path = trainer.save_checkpoint("sf")
    assert sorted(np.load(path).files) == sorted(np.load(golden).files)
    sd = trainer.model.state_dict()
    for tree in (jax_load(path), load_flax_checkpoint(path)):
        loaded = flax_to_state_dict(tree)
        assert loaded.keys() == sd.keys()
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    moved = flax_to_state_dict(load_flax_checkpoint(golden))["feature_extractor.conv1_1.running_mean"]
    assert not torch.equal(sd["feature_extractor.conv1_1.running_mean"], moved)
    fresh = SimpleFlowNet(device="cpu")
    fresh.load_state_dict(flax_to_state_dict(load_flax_checkpoint(path)))


def _cli(tmp_path, *extra):
    return train_flow.main(["--model", "ifnet", "--synthetic", "--batch_size", "2",
                            "--image_size", "32", "48", "--device", "cpu", "--val_freq", "1",
                            "--checkpoint_dir", str(tmp_path), *extra])


def test_train_flow_cli_two_synthetic_steps_and_resume(tmp_path):
    trainer = _cli(tmp_path, "--num_steps", "2")
    assert trainer.state.step == 2
    for name in ("ifnet.npz", "ifnet_1.npz", "ifnet_2.npz",
                 os.path.join("ifnet_state", "latest.pt"), os.path.join("ifnet_state", "step_00000002.pt")):
        assert os.path.exists(tmp_path / name), name
    weights = flax_to_state_dict(load_flax_checkpoint(str(tmp_path / "ifnet.npz")))
    assert all(torch.equal(weights[k], v) for k, v in trainer.model.state_dict().items())
    resumed = _cli(tmp_path, "--num_steps", "3", "--resume")
    assert resumed.state.step == 3
    assert resumed.state.optimizer.param_groups[0]["count"] == 3


def test_synthetic_batches_are_the_jax_clis():
    ours, ref = train_flow._synthetic_batches(2, (8, 12), 5), jax_synthetic_batches(2, (8, 12), 5)
    for _ in range(2):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_unported_parts_are_refused(tmp_path):
    # data parallelism is ported: a request for it that cannot be met raises
    with pytest.raises(ValueError, match="needs num_processes, process_id"):
        _cli(tmp_path, "--dist_coordinator", "localhost:1234")
    with pytest.raises(ValueError, match="needs coordinator_address"):
        _cli(tmp_path, "--dist_num_processes", "2", "--dist_process_id", "1")
    # the dataset stages are ported (data layer): a stage run reads its root
    with pytest.raises(FileNotFoundError, match="no_such_root"):
        train_flow.main(["--model", "ifnet", "--device", "cpu", "--data_root",
                         str(tmp_path / "no_such_root")])
    with pytest.raises(ValueError, match="unknown model_kind"):
        FlowTrainer("raft", (32, 48), device="cpu")
