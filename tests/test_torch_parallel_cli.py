"""Both training CLIs of the port as two gloo processes against one (CPU).

The design of the JAX package's `tests/test_cli_multiprocess.py`, on the
port's `--synthetic` data (no dataset on disk): `cli/train_raft.py`
(RAFT-standard at the chairs stage, BatchNorm training, 64x64, global batch
4, 2 iterations) and `cli/train_flow.py` (SimpleFlowNet, BatchNorm
training, 64x96, global batch 4), each started as the processes of a run
with `--dist_coordinator/--dist_num_processes/--dist_process_id` and
`--device cpu`.

  - After one step the 2-process weights file (`<name>_1.npz` of a
    2-step run, which validates and checkpoints every step) is the
    1-process one within the statistical bound of the JAX test (max |d| <
    1e-3, fewer than 1% of the elements off by more than 1e-6; AdamW's
    first update is about lr * sign(gradient), so a gradient within
    rounding of zero may flip);
  - the 2-process run stopped after its first step (a copy of its
    checkpoint directory without the step-2 state, as a run killed between
    the two steps leaves it) and resumed across fresh processes is the
    straight 2-process run (rtol 1e-5, atol 1e-6, as the JAX test: the same
    topology sums in the same order);
  - `cli/train_raft.py` started through the launcher's spawn path
    (`parallel/launch.py::run_workers`, 2 workers, the same arguments
    without `--dist_*`) writes the explicit 2-process run's files, bit for
    bit.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_worker as worker

CLIS = {
    "train_raft": ("raft", ["--stage", "chairs", "--synthetic", "--image_size", "64", "64",
                            "--batch_size", "4", "--iters", "2", "--lr", "4e-4"]),
    "train_flow": ("simple_flow", ["--model", "simple_flow", "--synthetic", "--image_size", "64",
                                   "96", "--batch_size", "4", "--lr", "1e-4"]),
}


def _args(cli, ckpt_dir, num_steps, extra=()):
    return [*CLIS[cli][1], "--num_steps", str(num_steps), "--val_freq", "1", "--num_workers", "1",
            "--device", "cpu", "--checkpoint_dir", str(ckpt_dir), *extra]


def _launch(cli, ckpt_dir, num_steps, num_procs, extra=()):
    port = worker.free_port()
    procs = []
    for i in range(num_procs):
        cmd = [sys.executable, "-m", f"raft_optical_flow_tpu_torch.cli.{cli}",
               *_args(cli, ckpt_dir, num_steps, extra)]
        if num_procs > 1:
            cmd += ["--dist_coordinator", f"127.0.0.1:{port}", "--dist_num_processes",
                    str(num_procs), "--dist_process_id", str(i)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=worker.REPO, env=worker.env()))
    return procs


def _run_workers(cli, ckpt_dir, num_steps, num_procs):
    """The launcher's run of num_procs workers, in a process of its own."""
    code = ("import sys; from raft_optical_flow_tpu_torch.parallel import launch; "
            "sys.exit(launch.run_workers(sys.argv[1], sys.argv[3:], int(sys.argv[2])))")
    cmd = [sys.executable, "-c", code, f"raft_optical_flow_tpu_torch.cli.{cli}", str(num_procs),
           *_args(cli, ckpt_dir, num_steps)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=worker.REPO, env=worker.env())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of both CLIs: the first two of each and the launcher's at
    once, then the resumes."""
    root = tmp_path_factory.mktemp("cli_mp")
    dirs = {(cli, run): root / f"{cli}_{run}" for cli in CLIS
            for run in ("single1", "multi2", "multi1r")}
    dirs["train_raft", "launch2"] = root / "train_raft_launch2"
    procs = [_run_workers("train_raft", dirs["train_raft", "launch2"], 2, 2)]
    for cli in CLIS:
        procs += _launch(cli, dirs[cli, "single1"], 1, 1)
        procs += _launch(cli, dirs[cli, "multi2"], 2, 2)
    worker.wait(procs)
    procs = []
    for cli in CLIS:  # the 2-step run as if killed after step 1, resumed afresh
        name = CLIS[cli][0]
        shutil.copytree(dirs[cli, "multi2"], dirs[cli, "multi1r"])
        for f in (f"{name}.npz", f"{name}_2.npz", os.path.join(f"{name}_state", "latest.pt"),
                  os.path.join(f"{name}_state", "step_00000002.pt")):
            os.remove(dirs[cli, "multi1r"] / f)
        procs += _launch(cli, dirs[cli, "multi1r"], 2, 2, extra=("--resume",))
    worker.wait(procs)
    return dirs


def _weights(ckpt_dir, name):
    with np.load(os.path.join(str(ckpt_dir), f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_two_processes_match_one(runs, cli):
    name = CLIS[cli][0]
    a, b = _weights(runs[cli, "multi2"], f"{name}_1"), _weights(runs[cli, "single1"], name)
    assert a.keys() == b.keys() and any("batch_stats" in k for k in a)
    d = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in sorted(a)])
    assert d.max() < 1e-3, f"max diff {d.max():.2e}"
    assert (d > 1e-6).mean() < 0.01, f"{(d > 1e-6).mean():.2%} of the weights differ"
    # only process 0 writes: one weights file per validation, the state under <name>_state
    files = sorted(os.listdir(runs[cli, "multi2"]))
    assert files == sorted([f"{name}.npz", f"{name}_1.npz", f"{name}_2.npz", f"{name}_state"])


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_resume_across_fresh_processes(runs, cli):
    name = CLIS[cli][0]
    a, b = _weights(runs[cli, "multi1r"], name), _weights(runs[cli, "multi2"], name)
    one = _weights(runs[cli, "multi2"], f"{name}_1")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert any(not np.array_equal(a[k], one[k]) for k in a)  # the resume took a step


def test_cli_through_the_launcher_is_the_explicit_processes(runs):
    name = CLIS["train_raft"][0]
    launched, explicit = runs["train_raft", "launch2"], runs["train_raft", "multi2"]
    assert sorted(os.listdir(launched)) == sorted(os.listdir(explicit))
    for f in (name, f"{name}_1", f"{name}_2"):
        a, b = _weights(launched, f), _weights(explicit, f)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a), f
