"""The compile check and the multi-card dry run: the port of
`__graft_entry__.py`.

`entry()` gives one out-of-core gemm superblock's K loop as a plain torch
function and its example arguments (on the card, kernel K1).
`dryrun_multichip(n)` runs the sharded paths once on a mesh of n ranks,
each phase against its reference answer, and prints a line a phase:

1. the tensor-parallel gemm step: K1 into a partial, a reduce-scatter
   over 'y', C += alpha * sum, over a K loop of two tiles
   (`parallel.mesh.sharded_accum_step`);
2. the data-parallel Lloyd step (B7, then an all-reduce);
3. `gemm_sharded` out of core, with ragged tails;
4. `csrmm_sharded` (K2 on each rank's row shard);
5. the sharded one-pass A^T A V operator of the eigensolver;
6. the sharded float64 gemm (K1 'f64' a shard), held to bof_tpu's scaled
   1e-12 bound;
7. block Lanczos with every operator application sharded, sigma against
   numpy's SVD.

Under torchrun, or in a process whose default process group has n ranks,
the body runs in this process on that group (one card a rank for cuda).
A process without a group runs n = 1 in-process on a world of its own
and otherwise starts n rank processes itself on a free localhost port
(gloo for the CPU, NCCL for cards), each with a time limit; a rank that
fails or runs out of time ends them all, and the error carries that
rank's last output.  Nothing falls back: cuda with fewer cards than n
raises.

    python -m bof_tpu_torch.dryrun [N] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 900.0


def entry(*, device: str = "cuda"):
    """(fn, example_args): one superblock's K loop, c + alpha * sum_l
    a_tiles[l] @ b_tiles[l], each step `ops/device.py:accum_step` (K1 on
    the card); the reference's shapes: 256 x 256 tiles, 2 k-tiles, seed
    0.  fn leaves its arguments unchanged and returns the new C."""
    from .ops import device as dev

    def fwd(c, a_tiles, b_tiles, alpha):
        # c: (bm, bn); a_tiles: (kB, bm, bk); b_tiles: (kB, bk, bn)
        c = c.clone()
        for a, b in zip(a_tiles, b_tiles):
            dev.accum_step(c, a, b, float(alpha), a_km=False, b_nk=False,
                           c_nm=False, prec="highest")
        return c

    target = dev.resolve_device(device)
    bm = bn = bk = 256
    kb = 2
    rng = np.random.default_rng(0)
    host = (np.zeros((bm, bn), np.float32),
            rng.standard_normal((kb, bm, bk)).astype(np.float32),
            rng.standard_normal((kb, bk, bn)).astype(np.float32))
    example_args = tuple(dev.to_device(x, target) for x in host) + (1.0,)
    return fwd, example_args


def _check_cards(n_devices: int, device: str) -> None:
    """cuda needs a card a rank: raise, naming both counts, rather than
    run on fewer."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}, device={device!r}): "
            "torch.cuda.is_available() is False, 0 cards for "
            f"{n_devices} rank(s); pass device='cpu' for gloo ranks")
    have = torch.cuda.device_count()
    if have < n_devices:
        raise ValueError(
            f"dryrun_multichip needs {n_devices} cards, one a rank; this "
            f"machine has {have}")


class _Phases:
    """Prints `[dryrun] phase '<name>' ok in ...` on rank 0 as each phase
    passes (so a stall is seen at its phase)."""

    def __init__(self, rank: int):
        self.rank = rank
        self.t0 = self.last = time.perf_counter()

    def ok(self, name: str) -> None:
        now = time.perf_counter()
        if self.rank == 0:
            print(f"[dryrun] phase '{name}' ok in {now - self.last:.1f}s "
                  f"(total {now - self.t0:.1f}s)", flush=True)
        self.last = now


def _shared_workdir(mesh) -> str:
    """A directory every rank sees: rank 0 makes it, the others get its
    path on the host group."""
    from .parallel import mesh as pmesh
    path = [tempfile.mkdtemp(prefix="bof_dryrun_")
            if pmesh.flat_rank(mesh) == 0 else None]
    if pmesh.n_ranks(mesh) > 1:
        dist.broadcast_object_list(path, src=0, group=pmesh._host_group())
    return path[0]


def _tp_gemm_step(mesh, sb: int, kb: int, rng) -> None:
    """bof_tpu's shard_map step: C over ("x", "y"), A tiles over
    (None, "x", "y"), B tiles over (None, "y", None); K1 into a zeroed
    partial, a reduce-scatter over 'y', C += alpha * sum, a K step at a
    time.  Each rank holds its C shard to float64."""
    from .parallel import mesh as pmesh
    a_np = rng.standard_normal((kb, sb, sb)).astype(np.float32)
    b_np = rng.standard_normal((kb, sb, sb)).astype(np.float32)
    c_sh = pmesh.sharding_for(mesh, ("x", "y"))
    b_sh = pmesh.sharding_for(mesh, ("y", None))
    step = pmesh.sharded_accum_step(mesh, prec="highest")
    c_loc = pmesh.device_put_sharded(np.zeros((sb, sb), np.float32), c_sh)
    for i in range(kb):
        c_loc = step(c_loc, pmesh.device_put_sharded(a_np[i], c_sh),
                     pmesh.device_put_sharded(b_np[i], b_sh), 1.0)
    got = c_loc.cpu().numpy()
    c_box = c_sh.box((sb, sb))
    want = sum(a_np[i].astype(np.float64) @ b_np[i].astype(np.float64)
               for i in range(kb))
    np.testing.assert_allclose(got, want[c_box].astype(np.float32),
                               rtol=2e-4, atol=1e-3)


def _dryrun_body(n_devices: int, device: str) -> None:
    """Every phase on this process's rank of an n-rank world (made by
    `make_mesh` when none exists: torchrun's env://, else one rank)."""
    import scipy.sparse as sps

    from . import FlashConfig, FlashContext, map_array, mem_array
    from .apps.eigensolver import (_apply_ata_one_pass_sharded,
                                   block_lanczos_svd)
    from .ops.gemm64 import gemm64
    from .ops.kmeans import kmeans_in_mem
    from .parallel import (csrmm_sharded, gemm_sharded, lloyds_iter_sharded,
                           make_mesh)
    from .parallel import mesh as pmesh
    from .sparse import CsrFlashMatrix

    mesh = make_mesh(n_devices, device=device)
    px, py = mesh.shape
    rank = pmesh.flat_rank(mesh)
    phase = _Phases(rank)

    sb = 8 * max(px, py) * py  # divisible by x, y and the scatter's blocks
    kb = 2
    rng = np.random.default_rng(1)  # every rank draws the same numbers
    _tp_gemm_step(mesh, sb, kb, rng)
    phase.ok("TP gemm step (K1 + reduce_scatter over 'y')")

    pts = rng.standard_normal((sb * 4 + 3, 8)).astype(np.float32)
    c0 = pts[:3].copy()
    got_c, _, counts = lloyds_iter_sharded(pts, c0, mesh=mesh)
    want_c, _ = kmeans_in_mem(pts, c0, n_iters=1)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-3, atol=1e-3)
    if int(np.asarray(counts).sum()) != len(pts):
        raise AssertionError(f"the Lloyd step counted "
                             f"{int(np.asarray(counts).sum())} of "
                             f"{len(pts)} points")
    phase.ok("DP Lloyd step")

    work = _shared_workdir(mesh)
    ctx = FlashContext(FlashConfig(
        device=device, scratch_dir=os.path.join(work, f"scratch_r{rank}"),
        program_budget=64 << 20, n_io_threads=2, n_compute_threads=1,
        pipeline_depth=2))

    def out_array(name, shape, dtype):
        """An output every rank writes its shards of: one shared file."""
        path = os.path.join(work, name)
        if rank == 0:
            map_array(path, shape, dtype, "R", create=True,
                      ctx=ctx).store.close()
        if n_devices > 1:
            pmesh.barrier()
        return map_array(path, shape, dtype, "R", ctx=ctx)

    try:
        mm, kk = sb * 2 + 3, sb + 1  # ragged tails exercise the padding
        a2 = rng.standard_normal((mm, kk)).astype(np.float32)
        b2 = rng.standard_normal((kk, sb)).astype(np.float32)
        A2 = mem_array((mm, kk), np.float32, data=a2, ctx=ctx)
        B2 = mem_array((kk, sb), np.float32, data=b2, ctx=ctx)
        C2 = out_array("C2.bin", (mm, sb), np.float32)
        gemm_sharded(A2, B2, C2, blk=sb, mesh=mesh, ctx=ctx)
        want2 = a2.astype(np.float64) @ b2.astype(np.float64)
        np.testing.assert_allclose(C2.read_all(), want2.astype(np.float32),
                                   rtol=2e-4, atol=1e-3)
        phase.ok("pipelined out-of-core gemm_sharded")

        a_sp = sps.random(96, 64, density=0.1, format="csr",
                          dtype=np.float32,
                          random_state=np.random.RandomState(2))
        As = CsrFlashMatrix.from_scipy(a_sp, ctx=ctx)
        b3 = rng.standard_normal((64, 16)).astype(np.float32)
        B3 = mem_array((64, 16), np.float32, data=b3, ctx=ctx)
        C3 = out_array("C3.bin", (96, 16), np.float32)
        csrmm_sharded(As, B3, C3, mesh=mesh, ctx=ctx)
        np.testing.assert_allclose(C3.read_all(), a_sp @ b3, rtol=2e-4,
                                   atol=1e-4)
        phase.ok("row-sharded csrmm_sharded")

        v4 = rng.standard_normal((64, 5)).astype(np.float32)
        u4 = _apply_ata_one_pass_sharded(As, v4, mesh, ctx)
        want4 = a_sp.T.astype(np.float64) @ (a_sp.astype(np.float64) @ v4)
        np.testing.assert_allclose(u4, want4, rtol=2e-4, atol=1e-4)
        phase.ok("sharded one-pass AtA operator")

        m5, k5, n5 = sb + 3, sb + 1, sb
        a5 = (rng.standard_normal((m5, k5))
              * 10.0 ** rng.uniform(-15, 15, (m5, 1)))
        b5 = rng.standard_normal((k5, n5))
        A5 = mem_array((m5, k5), np.float64, data=a5, ctx=ctx)
        B5 = mem_array((k5, n5), np.float64, data=b5, ctx=ctx)
        C5 = out_array("C5.bin", (m5, n5), np.float64)
        gemm64(A5, B5, C5, blk=sb, ctx=ctx, mesh=mesh)
        scl = np.abs(a5).max(1)[:, None] * np.abs(b5).max(0)[None, :]
        err5 = (np.abs(C5.read_all() - a5 @ b5)
                / np.maximum(scl * k5, 1e-300))
        if not err5.max() < 1e-12:
            raise AssertionError(f"float64 gemm error {err5.max():.3g} of "
                                 "the scaled bound 1e-12")
        phase.ok("mesh-sharded fp64 gemm (K1 'f64' a shard)")

        sigma6, _ = block_lanczos_svd(As, n_vals=3, max_kdim=16,
                                      n_restarts=2, tol=1e-8, seed=7,
                                      one_pass=True, mesh=mesh, ctx=ctx)
        want6 = np.linalg.svd(a_sp.toarray().astype(np.float64),
                              compute_uv=False)[:3]
        np.testing.assert_allclose(sigma6, want6, rtol=1e-3)
        phase.ok("sharded block-Lanczos SVD app")
    finally:
        if n_devices > 1:
            pmesh.barrier()
        ctx.destroy()
        if rank == 0:
            shutil.rmtree(work, ignore_errors=True)

    if rank == 0:
        print(f"dryrun_multichip OK on {n_devices} {mesh.device_type} "
              f"rank(s) (mesh {px}x{py}, superblock {sb}, K tiles {kb}; TP "
              "gemm step + DP lloyd step + pipelined out-of-core "
              "gemm_sharded + row-sharded csrmm + sharded one-pass AtA + "
              "sharded fp64 gemm + sharded block-Lanczos SVD app verified)",
              flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, nbytes: int = 4000) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - nbytes))
        return f.read().decode(errors="replace")


def _spawn_ranks(n_devices: int, device: str, timeout: float) -> None:
    """n rank processes of one env:// world on a free localhost port, each
    running `_dryrun_body`; rank 0's output is relayed.  The first rank
    that fails (or the time limit) ends every rank and raises with that
    rank's last output."""
    logs = tempfile.mkdtemp(prefix="bof_dryrun_logs_")
    port = _free_port()
    pp = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n_devices),
               PYTHONPATH=os.pathsep.join([_PKG_PARENT] + pp))
    procs, paths = [], []
    try:
        for r in range(n_devices):
            path = os.path.join(logs, f"rank{r}.log")
            paths.append(path)
            with open(path, "wb") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bof_tpu_torch.dryrun",
                     str(n_devices), "--device", device, "--rank-body"],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    cwd=_PKG_PARENT, stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = next(r for r, p in enumerate(procs)
                              if p.poll() is None)
                break
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode),
                          None)
        sys.stdout.write(_tail(paths[0], 1 << 20))
        sys.stdout.flush()
        if failed is not None:
            rc = procs[failed].poll()
            why = (f"ran out of its {timeout:.0f} s" if rc is None
                   else f"exited with code {rc}")
            raise RuntimeError(
                f"dryrun rank {failed} of {n_devices} {why}; its last "
                f"output:\n{_tail(paths[failed])}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(logs, ignore_errors=True)


def dryrun_multichip(n_devices: int, *, device: str = "cuda",
                     timeout: Optional[float] = None) -> None:
    """The sharded paths once on an n-rank mesh, every phase checked (see
    the module's docstring).  `timeout` bounds each spawned rank
    (RANK_TIMEOUT_S by default)."""
    _check_cards(n_devices, device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(
                f"dryrun_multichip({n_devices}) in a process group of "
                f"{dist.get_world_size()} rank(s)")
        _dryrun_body(n_devices, device)
        return
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        _dryrun_body(n_devices, device)  # torchrun's world (env://)
        return
    if n_devices == 1:
        try:
            _dryrun_body(1, device)  # a world of this process alone
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return
    _spawn_ranks(n_devices, device, timeout or RANK_TIMEOUT_S)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bof_tpu_torch.dryrun",
        description="The sharded paths once on a mesh of N ranks, checked.")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: the cards, or 1 on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--rank-body", action="store_true",
                    help=argparse.SUPPRESS)  # one rank of _spawn_ranks
    args = ap.parse_args(argv)
    n = args.n
    if n is None:
        n = (torch.cuda.device_count()
             if torch.device(args.device).type == "cuda" else 1)
    if args.rank_body:
        try:
            _dryrun_body(n, args.device)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return 0
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
