"""The four-card training mix (`traffic/things-train-4x5.json`, kept ready
for a later cell) on the CPU: four processes over gloo (a card run uses
NCCL), each with its rows of every global batch, the readings of every rank
compared on rank 0 with the reference's step on the global batch, under the
one-card stage's limits. Sound, the run reads `correct` true; with the
exchange between cards left out (no gradient all-reduce), false."""

import dataclasses
import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

from flowbench import harness

CELL = "raft-standard.things-train-4x5"  # a mix kept ready: no cell runs it yet
LIMITS_OF = "raft-standard.things-train-b5"  # the one-card stage's limits


def _worker(rank, world, port, cell, fault, out):
    torch.set_num_threads(1)
    from raft_optical_flow_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu")
    if fault:
        distributed.average_gradients = lambda params: None
    spec = harness.resolve(cell, chips=world)
    t = dict(spec.traffic, batch_per_chip=1, height=48, width=64, iters=2, ring=5)
    spec = dataclasses.replace(spec, traffic=t, limits=harness.resolve(LIMITS_OF).limits)
    ctx = harness.Context(spec=spec, seed=2**31 + 3, seconds=0.01, trace=False,
                          device=torch.device("cpu"), t0_wall=time.time(), rank=rank,
                          world=world)
    rec = harness.runner(spec).run(ctx)
    if rank == 0:
        out.put((rec.correct, rec.numbers, rec.global_batch))
    distributed.shutdown()


def _run(cell, fault):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.start_processes(_worker, args=(4, port, cell, fault, out), nprocs=4, start_method="spawn")
    return out.get()


@pytest.mark.parametrize("fault", [False, True])
def test_exchange(fault):
    correct, numbers, batch = _run(CELL, fault)
    assert batch == 4
    assert correct is (not fault), numbers
