"""What the mix runners share: the configuration's architecture, a
device synchronize, and the traced stretch."""

from __future__ import annotations

import sys
import time
from typing import Callable, List, Tuple

import torch

from flowbench import trace as ftrace
from flowbench.reference.raft import Arch

UPDATE_RANGE = "flowbench.update_block"


def arch_of(config) -> Arch:
    return Arch(small=bool(config["model"]["small"]), levels=int(config["model"]["corr_levels"]))


class Marks:
    """Set-up's phases on the wall clock from the process's start, printed on
    one line of standard error."""

    def __init__(self, t0_wall: float):
        self.last = time.time()
        self.phases: List[Tuple[str, float]] = [("start", self.last - t0_wall)]

    def __call__(self, name: str) -> None:
        now = time.time()
        self.phases.append((name, now - self.last))
        self.last = now

    def report(self) -> None:
        print("set-up phases (s): " + ", ".join(f"{n} {s:.3f}" for n, s in self.phases),
              file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def traced_stretch(block: torch.nn.Module,
                   stretch: Callable[[], None]) -> Tuple[ftrace.Trace, List[torch.Tensor]]:
    """stretch() under the profiler, each call of `block` (the update block)
    a host range `UPDATE_RANGE` opened and closed by forward hooks, and each
    call's flow input (its 4th argument: the lookup centres less the grid)
    kept for the lookup's bytes. The hooks exist only here."""
    from torch.profiler import record_function

    flows: List[torch.Tensor] = []
    ranges = []

    def pre(mod, args):
        flows.append(args[3].detach())
        ranges.append(record_function(UPDATE_RANGE))
        ranges[-1].__enter__()

    def post(mod, args, out):
        ranges.pop().__exit__(None, None, None)

    handles = [block.register_forward_pre_hook(pre), block.register_forward_hook(post)]
    try:
        events = ftrace.profile(stretch)
    finally:
        for h in handles:
            h.remove()
    return ftrace.Trace(events), flows
