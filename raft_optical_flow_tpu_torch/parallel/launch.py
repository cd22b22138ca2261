"""One training command over every visible card.

The JAX package's trainers take a mesh over every local device when given
none, so one `python -m raft_optical_flow_tpu.cli.train_raft ...` on a
four-chip host trains on all four. The port drives one device per process
(`parallel/distributed.py`), so the training CLIs call `over_local_cards`
first: when the command asks for no multi-process run of its own (no
`--dist_*` flag, no torchrun environment), names CUDA without an index, and
more than one card is visible, it starts one worker process per card, each
the same module and arguments plus

    --dist_coordinator 127.0.0.1:<free port> --dist_num_processes N
    --dist_process_id i

with LOCAL_RANK=i (so process i drives cuda:i), and waits for them.
`CUDA_VISIBLE_DEVICES` limits the cards, as JAX's visible devices do. The
batch size stays the global one and must split over the cards. Each worker
is a fresh interpreter (never a fork of a process that touched CUDA). The
launcher builds the CUDA and host libraries once before it starts them,
streams the lead worker's output as it is and the others' with a
`[process i]` prefix on stderr, and exits with the first non-zero exit code
of a worker, after terminating the rest: a worker that dies never leaves
the others waiting in a collective. On one card, on the CPU, or with an
index, nothing changes: the command runs in its own process.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

import torch

from raft_optical_flow_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GRACE_S = 30.0  # how long a worker gets to end after SIGTERM before SIGKILL


def local_workers(args) -> int:
    """The number of worker processes the command should run as (one per
    visible card), or 0 to run in this process. args: the CLI's parsed
    arguments (`dist_coordinator`, `dist_num_processes`, `dist_process_id`,
    `device`)."""
    if any(getattr(args, k) is not None
           for k in ("dist_coordinator", "dist_num_processes", "dist_process_id")):
        return 0
    if "WORLD_SIZE" in os.environ:  # a process of a torchrun launch
        return 0
    device = torch.device(args.device)
    if device.type != "cuda" or device.index is not None:
        return 0
    n = torch.cuda.device_count()
    return n if n > 1 else 0


def over_local_cards(module: str, argv: Sequence[str], args, batch_size: int) -> Optional[int]:
    """Run the command as one worker per visible card when `local_workers`
    says so, and return the launcher's exit code; None when the command
    should run in this process. module: the CLI's module name; argv: its
    arguments as given; batch_size: the global batch, which must split over
    the cards."""
    n = local_workers(args)
    if not n:
        return None
    distributed.assert_batch_divisible(batch_size, n)
    build_libraries()
    return run_workers(module, argv, n)


def build_libraries() -> None:
    """The CUDA kernels' and the data layer's libraries, built once here
    rather than by every worker at the same time."""
    from raft_optical_flow_tpu_torch.data import native
    from raft_optical_flow_tpu_torch.kernels import _build

    _build.build()
    native.build()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_commands(module: str, argv: Sequence[str], n: int, port: int) -> List[List[str]]:
    """The command line of each of the n workers."""
    return [[sys.executable, "-m", module, *argv, "--dist_coordinator", f"127.0.0.1:{port}",
             "--dist_num_processes", str(n), "--dist_process_id", str(i)] for i in range(n)]


def _die_with_parent() -> None:
    """In the child before exec (Linux): SIGTERM when the launcher dies, so
    that a killed launcher leaves no worker behind."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def spawn(cmd: List[str], env: dict, lead: bool) -> subprocess.Popen:
    """Start one worker: the lead's output goes where the launcher's goes;
    the others' through a pipe (see `_forward`)."""
    pipe = None if lead else subprocess.PIPE
    return subprocess.Popen(cmd, env=env, stdout=pipe, stderr=None if lead else subprocess.STDOUT,
                            text=True, preexec_fn=_die_with_parent if sys.platform == "linux"
                            else None)


def _forward(proc: subprocess.Popen, rank: int) -> threading.Thread:
    def run():
        for line in proc.stdout:
            sys.stderr.write(f"[process {rank}] {line}")
            sys.stderr.flush()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _exit_code(code: int) -> int:
    return 128 - code if code < 0 else code  # killed by signal s: 128 + s, as a shell says


def _end(procs: Sequence[subprocess.Popen]) -> None:
    """Terminate every worker still running; kill those that outlast GRACE_S."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_workers(module: str, argv: Sequence[str], n: int) -> int:
    """Start n workers of `module` with `argv` (process i with LOCAL_RANK=i),
    wait for all, and return 0, or the first non-zero exit code of a worker
    once every other one has been terminated (SIGTERM, then SIGKILL after
    GRACE_S seconds). A training run has no time limit of its own."""
    port = _free_port()
    procs, threads = [], []
    handler = None
    if threading.current_thread() is threading.main_thread():
        def on_term(signum, frame):
            raise SystemExit(128 + signum)

        handler = signal.signal(signal.SIGTERM, on_term)
    try:
        for i, cmd in enumerate(worker_commands(module, argv, n, port)):
            env = dict(os.environ, LOCAL_RANK=str(i))
            env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
            procs.append(spawn(cmd, env, lead=i == 0))
            if i > 0:
                threads.append(_forward(procs[-1], i))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return _exit_code(failed[0])
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        _end(procs)
        for t in threads:
            t.join(timeout=5.0)
        if handler is not None:
            signal.signal(signal.SIGTERM, handler)
