"""The training CLIs' launcher (`parallel/launch.py`) on the CPU, no process
started: `torch.cuda.device_count`, the spawn and the library build are
replaced, so these tests see what the launcher would run.

One command, no `--dist_*` flag, `--device cuda` (the default) and four
visible cards: four workers, the module and arguments as given plus the
coordinator, the count and the process id, LOCAL_RANK=i, the libraries
built once before. Not launched: one card, `--device cpu`, `--device
cuda:1`, an explicit `--dist_*` flag, a torchrun environment. A batch that
does not split over the cards raises `assert_batch_divisible`'s error
before anything starts. A worker that fails ends the others and gives its
exit code. The real launch (two gloo workers of `cli/train_raft.py`) is
held bit for bit to two explicit processes in `test_torch_parallel_cli.py`.
"""

import io
import subprocess
import sys

import pytest
import torch

from raft_optical_flow_tpu_torch.cli import train_flow, train_raft
from raft_optical_flow_tpu_torch.parallel import launch

CLIS = {
    "train_raft": (train_raft, ["--stage", "chairs", "--synthetic", "--batch_size", "8"]),
    "train_flow": (train_flow, ["--model", "simple_flow", "--synthetic", "--batch_size", "8"]),
}
DIST = ["--dist_coordinator", "127.0.0.1:29611", "--dist_num_processes", "2",
        "--dist_process_id", "0"]


class _Worker:
    """What `spawn` returns, for a worker that ends with `code` after
    `polls` polls (None: only when ended), having printed `out`; a
    stubborn one ends only when killed."""

    def __init__(self, code=0, polls=0, out="", stubborn=False):
        self.code, self.polls, self.stdout = code, polls, io.StringIO(out)
        self.stubborn, self.ended, self.killed = stubborn, None, False

    def poll(self):
        if self.ended is not None:
            return self.ended
        if self.polls is None or self.polls > 0:
            self.polls = self.polls and self.polls - 1
            return None
        return self.code

    def terminate(self):
        if not self.stubborn:
            self.ended = -15

    def kill(self):
        self.ended, self.killed = -9, True

    def wait(self, timeout=None):
        if self.poll() is None:
            raise subprocess.TimeoutExpired("worker", timeout)
        return self.poll()


@pytest.fixture
def spawned(monkeypatch):
    """The launcher's calls, in order: 'build', then (cmd, env, lead) per
    worker; each worker ends at once with exit code 0 unless the test sets
    `workers`."""
    calls, workers = [], []

    def fake_spawn(cmd, env, lead):
        calls.append((cmd, env, lead))
        return workers.pop(0) if workers else _Worker()

    monkeypatch.setattr(launch, "spawn", fake_spawn)
    monkeypatch.setattr(launch, "build_libraries", lambda: calls.append("build"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(launch.time, "sleep", lambda s: None)
    return calls, workers


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_four_cards_start_one_worker_each(spawned, monkeypatch, cli):
    calls, _ = spawned
    module, argv = CLIS[cli]
    _cards(monkeypatch, 4)
    assert module.main(argv) == 0
    assert calls[0] == "build" and len(calls) == 5
    port = calls[1][0][-5]
    assert port.startswith("127.0.0.1:")
    for i, (cmd, env, lead) in enumerate(calls[1:]):
        assert cmd == [sys.executable, "-m", f"raft_optical_flow_tpu_torch.cli.{cli}", *argv,
                       "--dist_coordinator", port, "--dist_num_processes", "4",
                       "--dist_process_id", str(i)]
        assert env["LOCAL_RANK"] == str(i) and lead == (i == 0)
        assert launch.REPO in env["PYTHONPATH"].split(":")


@pytest.mark.parametrize("extra, cards", [
    ([], 1),
    (["--device", "cpu"], 4),
    (["--device", "cuda:1"], 4),
    (DIST, 4),
    (DIST[2:4], 4),  # any one --dist_* flag
])
@pytest.mark.parametrize("cli", sorted(CLIS))
def test_no_launch_without_several_cards_or_with_a_choice_made(spawned, monkeypatch, cli, extra,
                                                               cards):
    calls, _ = spawned
    module, argv = CLIS[cli]
    _cards(monkeypatch, cards)
    args = module.parse_args(argv + extra)
    assert launch.local_workers(args) == 0
    assert launch.over_local_cards(f"raft_optical_flow_tpu_torch.cli.{cli}", argv + extra, args,
                                   args.batch_size) is None
    assert calls == []


def test_no_launch_inside_torchrun(spawned, monkeypatch):
    calls, _ = spawned
    _cards(monkeypatch, 4)
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launch.local_workers(train_raft.parse_args(CLIS["train_raft"][1])) == 0
    assert calls == []


def test_a_batch_that_does_not_split_over_the_cards_raises_first(spawned, monkeypatch):
    calls, _ = spawned
    _cards(monkeypatch, 4)
    with pytest.raises(ValueError, match="global batch size 10 not divisible by process count 4"):
        train_raft.main(["--stage", "chairs", "--synthetic", "--batch_size", "10"])
    assert calls == []


def test_a_failing_worker_ends_the_others_and_gives_its_code(spawned, capsys):
    calls, workers = spawned
    slow, failing, quiet = _Worker(polls=None), _Worker(code=3, polls=2, out="boom\n"), _Worker()
    workers += [slow, failing, quiet]
    assert launch.run_workers("some.module", ["--x"], 3) == 3
    assert slow.ended == -15 and quiet.ended is None
    assert [c[0][-1] for c in calls] == ["0", "1", "2"]
    assert "[process 1] boom" in capsys.readouterr().err


def test_a_worker_that_ignores_sigterm_is_killed_after_the_grace(spawned, monkeypatch):
    _, workers = spawned
    monkeypatch.setattr(launch, "GRACE_S", 0.0)
    hung, failing = _Worker(polls=None, stubborn=True), _Worker(code=1, polls=1)
    workers += [hung, failing]
    assert launch.run_workers("some.module", [], 2) == 1
    assert hung.killed and hung.ended == -9
