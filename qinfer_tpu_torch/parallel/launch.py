"""One process a rank on one host, joined in a ``torch.distributed`` process
group through a file store: no ``torchrun`` and no environment variables.

A parent calls ``run_ranks(argv, world)``. It makes a fresh temporary
directory, starts ``python *argv --rank r --world W --dir D`` for every
rank r, waits for them within a wall clock (and kills every rank still
running at its end), and returns what each rank wrote with
``write_result``. A rank parses those three arguments
(``add_rank_arguments``) and joins the group with ``process_group``, which
bounds every collective by the group's timeout and destroys the group
whatever happens. Each call of ``run_ranks`` is a world of its own: a
caller that wants worlds of several sizes calls it once per size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch.distributed as dist

__all__ = ["RankRun", "add_rank_arguments", "process_group", "run_ranks",
           "write_result"]

WALL_S = 900  # the ranks' whole run
GROUP_TIMEOUT_S = 300  # each collective


def add_rank_arguments(parser):
    """``--rank``, ``--world`` and ``--dir``, which ``run_ranks`` passes."""
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--dir", default=None, help=argparse.SUPPRESS)


@contextlib.contextmanager
def process_group(store_dir, rank, world, backend,
                  timeout_s=GROUP_TIMEOUT_S):
    """This process as rank ``rank`` of ``world`` (``backend``: 'nccl' on
    the cards, 'gloo' on the CPU), joined through the file store in
    ``store_dir``; the group is destroyed on exit."""
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


def write_result(store_dir, rank, result):
    """Rank ``rank``'s JSON result, for ``run_ranks`` to return."""
    with open(os.path.join(store_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


@dataclasses.dataclass
class RankRun:
    """What ``run_ranks`` saw: each rank's result (None where it wrote
    none), the tail of its output, its exit code, and how many ranks were
    still running at the wall clock (killed)."""

    results: list
    logs: list
    returncodes: list
    late: int

    @property
    def ok(self):
        return (self.late == 0 and all(c == 0 for c in self.returncodes)
                and all(r is not None for r in self.results))

    def failure(self):
        """A message naming each rank that failed, with its output's tail."""
        lines = [f"{self.late} ranks still ran at the wall clock"] * bool(
            self.late)
        for r, (res, code, log) in enumerate(zip(self.results,
                                                 self.returncodes,
                                                 self.logs)):
            if res is None or code != 0:
                lines.append(f"rank {r} exited {code}:\n{log}")
        return "\n".join(lines)


def run_ranks(argv, world, wall_s=WALL_S, log_tail=3000):
    """Runs ``sys.executable *argv --rank r --world world --dir D`` for
    r in 0 … world − 1 in a fresh temporary directory D; waits for all of
    them up to ``wall_s`` seconds, kills the rest, and returns a
    ``RankRun``."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"log{r}.txt"), "w")
                for r in range(world)]
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, *argv, "--rank", str(r), "--world",
                     str(world), "--dir", tmp],
                    stdout=logs[r], stderr=subprocess.STDOUT))
            deadline = time.monotonic() + wall_s
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            late = [p for p in procs if p.poll() is None]
            for p in late:
                p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        results, tails = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
            else:
                results.append(None)
            with open(os.path.join(tmp, f"log{r}.txt")) as f:
                tails.append(f.read()[-log_tail:])
    return RankRun(results, tails, [p.returncode for p in procs], len(late))
