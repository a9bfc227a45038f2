"""Run a function on every rank of a gloo world of spawned processes.

The port's multi-process tests start one :class:`World` per module (from a
module-scoped fixture) with a worker that runs all of the module's cases
and returns their results; the test process, which holds JAX, computes the
JAX package's results meanwhile and then compares. The workers are spawned, not forked,
and import only the worker's module, so a module that spawns keeps its JAX
imports inside its test functions. The rendezvous is a file in a temporary
directory; the process group's set-up and every collective have a
60 s timeout, and the whole run ``timeout`` seconds, so a hang fails the
test instead of holding the suite.
"""

import os
import time

import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60


def init_rank(rank: int, world: int, rendezvous: str) -> None:
    """Join a gloo world through the port's ``comm.init_distributed``."""
    from deepspeed_tpu_torch import comm

    comm.init_distributed(device="cpu", init_method=f"file://{rendezvous}", rank=rank,
                          world_size=world, timeout=GROUP_TIMEOUT_S, verbose=False)


def _entry(rank, fn, world, out_dir, args):
    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    init_rank(rank, world, os.path.join(out_dir, "rendezvous"))
    try:
        result = fn(rank, world, out_dir, *args)
    finally:
        comm.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


class World:
    """``fn(rank, world, out_dir, *args)`` running on each rank of a new
    gloo world of spawned processes; :meth:`join` returns each rank's
    result in rank order, or raises with a failed rank's traceback."""

    def __init__(self, fn, world: int, out_dir: str, args=(), timeout: float = 240.0):
        os.makedirs(out_dir, exist_ok=True)
        self.name, self.world, self.out_dir, self.timeout = fn.__name__, world, out_dir, timeout
        self._deadline = time.monotonic() + timeout
        self._ctx = mp.start_processes(_entry, args=(fn, world, out_dir, tuple(args)),
                                       nprocs=world, join=False, start_method="spawn")

    def join(self):
        try:
            while not self._ctx.join(timeout=1.0):
                if time.monotonic() > self._deadline:
                    raise TimeoutError(f"{self.name} did not finish on {self.world} ranks in "
                                       f"{self.timeout:.0f} s")
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def wait_for(path: str, timeout: float = 120.0) -> None:
    """Block until ``path`` exists (a file the test process writes for the
    ranks)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout:.0f} s")
        time.sleep(0.05)
