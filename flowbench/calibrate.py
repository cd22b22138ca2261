"""Readings that set a cell's correctness limits: the program's, the
control's and the planted faults', over many seeds, in one process (one per
card for a cell on several cards).

    python3 flowbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--systems program,control] [--seconds 1] [--chips N] [--out FILE]

For each seed and system it runs the cell's runner (set-up, a short window,
the comparison with the reference) with that system in the program's place
and prints one JSON line of the compared numbers. Systems:

  - `program`: the program under test;
  - `control`: the reference one precision step below the configuration's
    policy;
  - `half` (training): the reference in the configuration's policy whose
    step takes the mean over the first half of the batch's rows only (the
    fault "half of the batch left out");
  - `no_exchange` (training on several cards): the program with its
    gradient all-reduce left out (the fault "the exchange between chips
    left out").

A cell on several cards (or a `<config>.<traffic>` mix on `--chips` cards)
runs one worker per card. The limits in
`workloads/<cell>.json` are set from these readings (PERF.md gives them).
Needs CUDA cards; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from flowbench import harness, run  # noqa: E402


def fault_systems(runner_module):
    """The planted faults of a training runner, by name."""

    class HalfBatch(runner_module.ReferenceSystem):
        def __init__(self, ctx, weights, arch):
            super().__init__(ctx, weights, arch, ctx.spec.config["policy"])

        def step(self, batch):
            n = batch["image1"].shape[0]
            return super().step({k: v[: max(n // 2, 1)] for k, v in batch.items()})

    class NoExchange(runner_module.ProgramSystem):
        def step(self, batch):
            from raft_optical_flow_tpu_torch.parallel import distributed

            orig = distributed.average_gradients
            distributed.average_gradients = lambda params: None
            try:
                return super().step(batch)
            finally:
                distributed.average_gradients = orig

    return {"half": HalfBatch, "no_exchange": NoExchange}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--systems", default="program,control")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--chips", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch

    spec = harness.resolve(args.workload, chips=args.chips)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"calibration needs {spec.chips} CUDA card(s)", file=sys.stderr)
        return 2
    if spec.chips > 1 and args.rank is None:
        return run.launch([sys.executable, os.path.abspath(__file__)] + list(argv or sys.argv[1:]),
                          spec.chips)
    rank = args.rank or 0
    device = run.join_group(rank, args.port, spec.chips)
    mix = harness.runner(spec)
    if spec.traffic["kind"] == "train":
        mix.SYSTEMS.update(fault_systems(mix))
    out = open(args.out, "a") if args.out and rank == 0 else None
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            for system in args.systems.split(","):
                t = time.time()
                ctx = harness.Context(spec=spec, seed=seed, seconds=args.seconds, trace=False,
                                      device=device, t0_wall=t, rank=rank, world=spec.chips,
                                      system=system)
                rec = mix.run(ctx)
                if rank == 0:
                    line = json.dumps({"workload": args.workload, "seed": seed, "system": system,
                                       "chips": spec.chips, "numbers": rec.numbers,
                                       "seconds": time.time() - t})
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
        run.leave_group(spec.chips)
    return 0


if __name__ == "__main__":
    sys.exit(main())
