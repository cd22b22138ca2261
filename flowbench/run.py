"""Run one benchmark cell once and print its result line.

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in `BENCHMARK.json` names its
configuration, traffic and chips; `flowbench/harness.py` says where each
piece lives. Needs as many CUDA cards as the cell asks for: without them it
exits with code 2 and prints no result. A cell on several cards runs one
worker process per card (NCCL over `tcp://127.0.0.1:<free port>`); rank 0
prints the result.

With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled stretch that
follows the unprofiled window. The last lines on standard error, and the
result's last key `checks`, give each number that decides `correct` beside
its limit.
"""

from __future__ import annotations

import time

T0_WALL = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from flowbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one worker of a cell on several cards
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd, chips: int) -> int:
    """Run `cmd` as one worker per card (each with `--rank r --port p` and
    LOCAL_RANK=r); rank 0's output is this process's, the others' standard
    output goes to standard error. Returns the first non-zero exit code,
    after ending the other workers, or 0."""
    port = _free_port()
    procs = []
    try:
        for r in range(chips):
            env = dict(os.environ, LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(cmd + ["--rank", str(r), "--port", str(port)], env=env,
                                          stdout=None if r == 0 else sys.stderr))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def join_group(rank: int, port: int, chips: int):
    """This worker's card, in the process group of the cell's cards."""
    import torch

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if chips > 1:
        from raft_optical_flow_tpu_torch.parallel import distributed

        distributed.initialize(f"127.0.0.1:{port}", chips, rank, device=device)
    return device


def leave_group(chips: int) -> None:
    if chips > 1:
        from raft_optical_flow_tpu_torch.parallel import distributed

        distributed.shutdown()


def device_info(record, chips: int) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(record.process_peak_bytes)}
    if record.trace is not None:
        out["busy_s"] = record.trace.busy_s
        out["window_s"] = record.trace.window_s
    return out


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    spec = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if spec.chips > 1 and args.rank is None:
        return launch([sys.executable, os.path.abspath(__file__), "--workload", args.workload,
                       "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
                       str(args.trace), "--t0", repr(T0_WALL)], spec.chips)
    rank = args.rank or 0
    device = join_group(rank, args.port, spec.chips)
    ctx = harness.Context(spec=spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          device=device, t0_wall=args.t0 if args.t0 is not None else T0_WALL,
                          rank=rank, world=spec.chips)
    record = harness.runner(spec).run(ctx)
    leave_group(spec.chips)
    if rank != 0:
        return 0
    metrics = harness.read_metrics(record, spec.per_layer if args.trace else spec.end_to_end)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = harness.result_line(record, metrics, device_info(record, spec.chips))
    harness.print_checks(record)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
