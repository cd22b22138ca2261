"""Worker of the port's multi-process tests (tests/test_torch_parallel*.py).

One process of a gloo run on the CPU (or the one-process reference):

    python torch_dist_worker.py <job> <num_processes> <process_id> <port> <dir>

The tests start the processes of a run with `launch` and read what they
wrote with `results`.

With num_processes == 1 it joins no process group and runs the port's
one-device path, the reference the multi-process runs are held to. Jobs:

  raft_bn  RAFT-standard, chairs stage (BatchNorm training), one
           `RAFTTrainer.train_step` on this process's rows of the global batch
           in <dir>/batch.npz, from the flax-layout weights in
           <dir>/weights.npz;
  kinds    every `FlowTrainer` step kind and the RAFT step (RAFT-small with
           dropout and input noise), one step each at tiny sizes, from
           seeded weights (each process seeds its model differently: the
           trainers start every process from process 0's), plus UFlow's
           random crop and shift drawn inside `data_parallel`;
  spatial  `spatial_sharded_ondemand_corr` on a ('data', 'space') mesh of
           shape (1, num_processes) over <dir>/corr.npz's inputs, the slabs
           gathered;
  spatial_grad  the same function's gradients (fmap1 and each level) on the
           same mesh and inputs, of sum(slab ** 2) (each process its slab
           loss) and of sum(all_gather_rows(slab) ** 2) (every process the
           loss of the whole).

Each process writes <dir>/<job>_<num_processes>_<process_id>.npz. One torch
thread per process.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from raft_optical_flow_tpu_torch.parallel import distributed  # noqa: E402
from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: E402

FLOW_KINDS = ("lfn3", "lfn3_unsup", "simple_flow", "simple_flow_unsup", "ifnet", "ifnet_unsup",
              "raft_uflow_unsup")
STEP_HW = {"raft_uflow_unsup": (48, 64), "raft": (64, 64)}  # the families: 64x96
# occlusion masks and the full self-supervision weight from the first step
UFLOW_KW = dict(iters=2, selfsup_crop=8, occlusion_warmup_steps=-1, selfsup_ramp_steps=1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env() -> dict:
    e = dict(os.environ)
    e["OMP_NUM_THREADS"] = "1"
    return e


def launch(job: str, num: int, directory) -> list:
    """Start the num processes of a run of `job` (one, the reference, for
    num == 1); `wait` ends them."""
    port = free_port()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(num), str(i),
                              str(port), str(directory)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=REPO, env=env())
            for i in range(num)]


def wait(procs, timeout: float = 300.0) -> None:
    """Each process's end within `timeout` seconds, exit code 0 (else the
    others are killed and its error raised)."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def results(job: str, num: int, directory) -> list:
    """What each process of a run wrote, by rank."""
    out = []
    for i in range(num):
        with np.load(os.path.join(str(directory), f"{job}_{num}_{i}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def _record(out, tag, metrics, model):
    from raft_optical_flow_tpu_torch.utils.weights import state_dict_to_flax

    for k, v in metrics.items():
        out[f"{tag}:metric:{k}"] = np.float64(float(v))
    flat = {}
    _flat("", state_dict_to_flax(model.state_dict()), flat)
    for k, v in flat.items():
        out[f"{tag}:var:{k}"] = v


def _batch(rng, B, H, W):
    return {
        "image1": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
        "image2": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
        "flow": rng.uniform(-5, 5, (B, H, W, 2)).astype(np.float32),
        "valid": (rng.uniform(0, 1, (B, H, W)) > 0.2).astype(np.float32),
    }


def job_raft_bn(mesh, out, directory, rank):
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    with np.load(os.path.join(directory, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    B, H, W = batch["image1"].shape[:3]
    stage = StageConfig(name="mp", stage="chairs", num_steps=10, batch_size=B, lr=4e-4,
                        image_size=(H, W), freeze_bn=False, iters=2)
    weights = load_flax_checkpoint(os.path.join(directory, "weights.npz"))
    trainer = RAFTTrainer(stage, config=RAFTConfig(), mesh=mesh, device="cpu",
                          restore_variables=weights)
    local = shard_batch(batch, mesh) if mesh is not None else batch
    metrics = trainer.train_step(local)
    _record(out, "raft_bn", metrics, trainer.model)


def job_kinds(mesh, out, directory, rank):
    from raft_optical_flow_tpu_torch.losses import uflow
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer
    from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer, OptimConfig

    for i, kind in enumerate(FLOW_KINDS + ("raft",)):
        H, W = STEP_HW.get(kind, (64, 96))
        batch = _batch(np.random.RandomState(10 + i), 4, H, W)
        if kind == "raft":
            stage = StageConfig(name="raft", stage="things", num_steps=10, batch_size=4,
                                lr=4e-4, image_size=(H, W), iters=2, add_noise=True,
                                seed=1234 + rank)
            trainer = RAFTTrainer(stage, RAFTConfig(small=True, dropout=0.25), mesh=mesh,
                                  device="cpu")
        else:
            trainer = FlowTrainer(kind, (H, W), optim=OptimConfig(lr=1e-4, step_size=100),
                                  mesh=mesh, seed=1234 + rank, device="cpu",
                                  step_kwargs=UFLOW_KW if kind == "raft_uflow_unsup" else None)
        local = shard_batch(batch, mesh) if mesh is not None else batch
        _record(out, kind, trainer.train_step(local), trainer.model)
        out[f"{kind}:generator"] = trainer.state.generator.get_state().numpy()

    # UFlow's crop and shift, drawn for the global batch inside data_parallel
    images = torch.from_numpy(np.random.RandomState(3).uniform(0, 1, (4, 20, 24, 3))
                              .astype(np.float32))
    if mesh is not None:
        images = shard_batch(images, mesh)
    gen = torch.Generator().manual_seed(7)
    with distributed.data_parallel(mesh.group("data") if mesh is not None else None):
        crop, offsets = uflow.random_crop(gen, images, 6, 8)
        shift, shifts = uflow.random_shift(gen, images, 5, 7)
    for k, v in (("crop", crop), ("offsets", offsets), ("shift", shift), ("shifts", shifts)):
        out[f"draw:{k}"] = v.numpy()


def job_spatial(mesh, out, directory, rank):
    from raft_optical_flow_tpu_torch.parallel.spatial import (
        all_gather_rows,
        spatial_sharded_ondemand_corr,
    )

    with np.load(os.path.join(directory, "corr.npz")) as z:
        fmap1, coords = torch.from_numpy(z["fmap1"]), torch.from_numpy(z["coords"])
        pyr = [torch.from_numpy(z[f"level{i}"]) for i in range(int(z["levels"]))]
        radius = int(z["radius"])
    try:
        spatial_sharded_ondemand_corr(fmap1[:, 1:], pyr, coords[:, 1:], radius, mesh)
        out["odd_rows_raised"] = np.int64(0)
    except ValueError as e:
        out["odd_rows_raised"] = np.int64("must divide the 'space' axis" in str(e))
    slab = spatial_sharded_ondemand_corr(fmap1, pyr, coords, radius, mesh)
    out["slab"] = slab.numpy()
    out["gathered"] = all_gather_rows(slab, mesh).numpy()


def job_spatial_grad(mesh, out, directory, rank):
    from raft_optical_flow_tpu_torch.parallel.spatial import (
        all_gather_rows,
        spatial_sharded_ondemand_corr,
    )

    with np.load(os.path.join(directory, "corr.npz")) as z:
        fmap1, coords = torch.from_numpy(z["fmap1"]), torch.from_numpy(z["coords"])
        pyr = [torch.from_numpy(z[f"level{i}"]) for i in range(int(z["levels"]))]
        radius = int(z["radius"])
    for case in ("slab", "whole"):
        f1 = fmap1.clone().requires_grad_(True)
        levels = [p.clone().requires_grad_(True) for p in pyr]
        slab = spatial_sharded_ondemand_corr(f1, levels, coords, radius, mesh)
        if case == "whole":
            slab = all_gather_rows(slab, mesh)
        (slab ** 2).sum().backward()
        out[f"{case}:df1"] = f1.grad.numpy()
        for i, p in enumerate(levels):
            out[f"{case}:df2_{i}"] = p.grad.numpy()


def main():
    job, num, pid, port, directory = sys.argv[1:6]
    num, pid = int(num), int(pid)
    torch.set_num_threads(1)
    mesh = None
    if num > 1:
        distributed.initialize(f"127.0.0.1:{port}", num, pid, device="cpu")
        if job.startswith("spatial"):  # a 2-D mesh: the 'space' axis over the processes
            mesh = make_mesh(axis_names=("data", "space"), shape=(1, num), device="cpu")
        else:
            mesh = make_mesh(device="cpu")
        assert mesh.device == torch.device("cpu") and num in mesh.shape.values()
    elif job.startswith("spatial"):
        mesh = make_mesh(axis_names=("data", "space"), device="cpu")
    out = {}
    {"raft_bn": job_raft_bn, "kinds": job_kinds, "spatial": job_spatial,
     "spatial_grad": job_spatial_grad}[job](mesh, out, directory, pid)
    np.savez(os.path.join(directory, f"{job}_{num}_{pid}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    main()
