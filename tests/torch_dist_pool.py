"""A pool of torch.distributed gloo ranks for the port's multi-rank tests.

`RankPool(world)` spawns `world` processes that join one gloo process group
on a free localhost port (with a timeout, so a dead rank fails the test
instead of hanging it) and then run jobs: `pool.run(fn, *args)` runs
`fn(rank, world, *args)` on every rank and returns the ranks' results in
rank order, or raises with every failing rank's traceback.  A pool that
saw a failure is closed (its group may be broken), and `pools.get(world)`
starts a new one.  The rank processes import torch and bof_tpu_torch,
never jax: the job functions live in `torch_dist_jobs.py`.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import queue
import socket
import traceback

GLOO_TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, jobs, results) -> None:
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        import bof_tpu_torch  # noqa: F401  (the jobs' import cost, once)
        results.put((rank, True, "ready"))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, True, fn(rank, world, *args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self.broken = False
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        port = _free_port()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, port, self._jobs[r],
                                         self._results), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._gather(120)

    def _gather(self, timeout: float):
        outs, errs = {}, {}
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        while len(outs) + len(errs) < self.world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, out = self._results.get(timeout=max(left, 0.1))
            except queue.Empty:
                self.broken = True
                self.close()
                raise TimeoutError(
                    f"{self.world - len(outs) - len(errs)} rank(s) gave no "
                    f"result in {timeout} s")
            (outs if ok else errs)[rank] = out
        if errs:
            self.broken = True
            self.close()
            raise AssertionError("\n".join(
                f"rank {r}:\n{tb}" for r, tb in sorted(errs.items())))
        return [outs[r] for r in range(self.world)]

    def run(self, fn, *args, timeout: float = 240):
        """fn(rank, world, *args) on every rank; the results in rank
        order."""
        for q in self._jobs:
            q.put((fn, args))
        return self._gather(timeout)

    def close(self):
        for q in self._jobs:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


class Pools:
    """The live pool of the last world size asked for: a request for
    another size closes it first (so one file's ranks never stack up),
    and a broken pool is replaced."""

    def __init__(self):
        self._pools: dict = {}

    def get(self, world: int) -> RankPool:
        pool = self._pools.get(world)
        if pool is None or pool.broken:
            self.close()
            pool = self._pools[world] = RankPool(world)
        return pool

    def close(self):
        for pool in self._pools.values():
            pool.close()
        self._pools.clear()


def scratch_of(base: str, rank: int) -> str:
    path = os.path.join(base, f"scratch_r{rank}")
    os.makedirs(path, exist_ok=True)
    return path


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of this process alone and its 1 x 1 CPU mesh, for a
    test of a mesh path without spawning; the process group is destroyed
    on the way out, so later tests find none."""
    import torch.distributed as dist

    from bof_tpu_torch.parallel import make_mesh
    try:
        yield make_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
