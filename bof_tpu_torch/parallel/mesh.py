"""The device mesh and the sharded GEMM, on torch.distributed.

The port of `bof_tpu/parallel/mesh.py`: the out-of-core superblock
accumulate step scaled over a 2-D mesh with axes ("x", "y").  The layout
is bof_tpu's, for C += A @ B:

    A superblock: rows over x, K over y        ("x", "y")
    B superblock: K over y, columns replicated ("y", None)
    C superblock: rows over x, columns over y  ("x", "y")

bof_tpu drives every device of its mesh from one process.  Here there is
one process a card, as torch.distributed has it: `make_mesh` returns a
`DeviceMesh` of shape (px, py) over the world's ranks, rank r at
(r // py, r % py).  Each rank multiplies its (m/px, K/py) x (K/py, n)
panels with kernel K1 into a zeroed partial, and a reduce-scatter over
its 'y' group sums the K partials and scatters the n dimension, so C
never exists unsharded on a card.

The results are those of bof_tpu's single-process mesh of the same
px x py at any world size.  A world of one rank reads whole tiles, as
bof_tpu's single process does.  In a larger world each rank reads only
the byte ranges of its own shards and writes back only its own C shard,
as bof_tpu's multi-host branch does; the caller's C must then be one
file every rank sees.  Where that branch gives less than one process,
the smallest collective keeps the single-process answer: the int8
transfer mode's scale is the whole tile's max|x|, reached by a max over
the ranks' shard maxima on a host (gloo) group.

A world that is not initialized (a program run without torchrun) becomes
a world of one rank on the configured device: NCCL for the card, gloo for
the CPU.  Nothing falls back: a mesh larger than the world raises.
Collectives are counted in METRICS under `dist.<name>`.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import METRICS

_FORCE_SHARDED_READS = False  # test hook: exercise the per-rank read path
# in a world of one rank

# per initialized world: the meshes made so far and the host (gloo) group
# the sharded readers use for their scalar maxima
_STATE: dict = {}


def _near_square(n: int) -> Tuple[int, int]:
    """bof_tpu's mesh shape for n devices: the largest px <= sqrt(n) that
    divides n (8 -> 2x4, 6 -> 2x3, 4 -> 2x2)."""
    px = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            px = cand
            break
    return px, n // px


def _world_state() -> dict:
    world = dist.group.WORLD
    if _STATE.get("world") is not world:
        _STATE.clear()
        _STATE.update(world=world, meshes={}, host=None)
    return _STATE


def _init_world(device_type: str) -> None:
    """The world torchrun describes in the environment (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT), else a world of one rank (this process) on
    an in-process store."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    timeout = datetime.timedelta(minutes=30)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def _check_backend(device_type: str) -> None:
    backend = str(dist.get_backend())
    want = "nccl" if device_type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"the process group's backend is {backend!r}; a "
                         f"{device_type} mesh needs {want}")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("x", "y"), *,
              device: Optional[str] = None):
    """A near-square 2-D `DeviceMesh` over the world's ranks, one card (or
    CPU process) a rank.  The device type is `device`'s, by default the
    current context's `FlashConfig.device` (a card without one raises);
    each rank computes on cuda:<local rank>
    (`LOCAL_RANK`, else rank modulo the cards).  It uses the default
    process group when one is initialized, else it initializes the world
    torchrun's environment describes, or a world of one rank.
    `n_devices` other than the world size raises: there are no virtual
    devices to fall back to."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..context import get_context
    from ..ops import device as dev

    device = dev.resolve_device(device or get_context().config.device)
    if not dist.is_initialized():
        _init_world(device.type)
    _check_backend(device.type)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"need {n} devices; the world has {world} rank(s), one device "
            "each (start one process a card, e.g. torchrun "
            f"--nproc-per-node {n})")
    if device.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    state = _world_state()
    shape = _near_square(n)
    key = (shape, tuple(axis_names), device.type)
    if key not in state["meshes"]:
        state["meshes"][key] = init_device_mesh(
            device.type, shape, mesh_dim_names=tuple(axis_names))
    if state["host"] is None:
        state["host"] = dist.new_group(backend="gloo")
    return state["meshes"][key]


def _host_group():
    return _world_state()["host"]


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on for `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_coords(mesh) -> Tuple[int, int, int, int]:
    """(px, py, xi, yi): the mesh's shape and this rank's place in it."""
    px, py = mesh.shape
    xi, yi = mesh.get_coordinate()
    return px, py, xi, yi


def n_ranks(mesh) -> int:
    return int(np.prod(mesh.shape))


def flat_rank(mesh) -> int:
    """This rank's index over both axes, x major (bof_tpu's row order of a
    dimension sharded over every mesh axis)."""
    px, py, xi, yi = mesh_coords(mesh)
    return xi * py + yi


def row_shard(mesh, rows_pad: int) -> Tuple[int, int]:
    """[p0, p1): this rank's rows of a (rows_pad, ...) block sharded over
    every mesh axis (rows_pad a multiple of the ranks)."""
    n_dev = n_ranks(mesh)
    if rows_pad % n_dev:
        raise ValueError(f"{rows_pad} rows do not divide over {n_dev} ranks")
    step = rows_pad // n_dev
    r = flat_rank(mesh)
    return r * step, (r + 1) * step


def row_run(mesh, n: int) -> Tuple[int, int, int]:
    """(lo, hi, run): this rank's real rows [lo, hi) of n rows padded to a
    multiple of the ranks and sharded over every mesh axis, `run` rows a
    rank (the rows past n are padding, never computed)."""
    p0, p1 = row_shard(mesh, n + (-n) % n_ranks(mesh))
    return min(p0, n), min(p1, n), p1 - p0


# ------------------------------------------------------ counted collectives

def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    METRICS.add("dist.reduce_scatter")
    dist.reduce_scatter_tensor(out, inp, group=group)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> None:
    METRICS.add("dist.all_reduce")
    dist.all_reduce(t, op=op, group=group)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    METRICS.add("dist.all_gather")
    dist.all_gather_into_tensor(out, inp, group=group)


def host_max(x: float) -> float:
    """The max of a host float over every rank, on the host group (the
    sharded readers' threads never share a group with the main thread's
    device collectives)."""
    t = torch.tensor([x], dtype=torch.float64)
    METRICS.add("dist.host_max")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return float(t[0])


def barrier() -> None:
    """Every rank's writes are done: the host group's barrier."""
    METRICS.add("dist.barrier")
    dist.barrier(group=_host_group())


@contextlib.contextmanager
def shard_writer(arr, mesh):
    """The array to write this rank's shards of `arr` through: `arr` in a
    world of one rank, else, when its store writes with O_DIRECT, the same
    file opened buffered.  An O_DIRECT write that does not cover whole
    512-byte sectors reads, modifies and writes the sectors it touches,
    serialized only within one process, so two ranks writing neighbouring
    shards of one sector would lose one's update; buffered writes of
    disjoint bytes do not.  The buffered store is flushed (fsync) and
    closed on the way out, and the range dropped from `arr`'s caches,
    before the caller's barrier."""
    from ..core.flash_array import FlashArray
    from ..io.stride import StrideInfo
    if n_ranks(mesh) == 1 or not getattr(arr.store, "o_direct", False):
        yield arr
        return
    store = arr.ctx.open_store(arr.store.path, o_direct=False)
    try:
        yield FlashArray(store, arr.shape, arr.dtype, arr.order,
                         offset=arr.offset, ld=arr.ld, ctx=arr.ctx)
        store.flush()
    finally:
        store.close()
    lo, hi = arr.file_span()
    arr.ctx.coherence_invalidate(arr.store, lo,
                                 StrideInfo.contiguous(hi - lo))


def shared_empty(shape, dtype, mesh, ctx, order: str = "R"):
    """A scratch array every rank of the mesh reads and writes (the apps'
    intermediate panels, which the ranks write shard by shard and then
    read whole): rank 0 makes the scratch file and the others open it by
    the path it broadcasts, so the scratch directory must be one every
    rank sees.  In a world of one rank, `flash_empty`.  Free it with
    `shared_free`."""
    from ..core.flash_array import flash_empty, map_array
    if n_ranks(mesh) == 1:
        return flash_empty(shape, dtype, order, ctx=ctx)
    arr = flash_empty(shape, dtype, order, ctx=ctx) if flat_rank(mesh) == 0 \
        else None
    path = [None if arr is None else arr.store.path]
    METRICS.add("dist.broadcast")
    dist.broadcast_object_list(path, src=0, group=_host_group())
    if arr is None:
        arr = map_array(path[0], shape, dtype, order, ctx=ctx)
    return arr


def shared_free(arr, mesh) -> None:
    """Free a `shared_empty` array once every rank is done with it."""
    from ..core.flash_array import flash_free
    if n_ranks(mesh) > 1:
        barrier()
    flash_free(arr)


# ------------------------------------------------------------- shardings

class Sharding(NamedTuple):
    """bof_tpu's NamedSharding(mesh, spec) for a 2-D block: one entry a
    dimension, None (replicated) or an axis name, "x" or "y" (rows over
    every axis go through `row_shard`)."""
    mesh: object
    spec: tuple

    def box(self, shape) -> Tuple[slice, ...]:
        """This rank's slices of an array of `shape` (each sharded dim
        must divide evenly)."""
        px, py, xi, yi = mesh_coords(self.mesh)
        parts = {"x": (px, xi), "y": (py, yi)}
        out = []
        for dim, ax in zip(shape, tuple(self.spec) + (None,) * len(shape)):
            n, i = parts[ax] if ax is not None else (1, 0)
            if dim % n:
                raise ValueError(f"dimension {dim} does not divide over "
                                 f"{n} ranks ({ax})")
            out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
        return tuple(out)


def sharding_for(mesh, spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def device_put_sharded(host_np: np.ndarray, sharding: Sharding
                       ) -> torch.Tensor:
    """This rank's shard of `host_np` on its device (bof_tpu's multi-host
    upload: each process uploads only the shards it owns)."""
    from ..ops import device as dev
    return dev.to_device(host_np[sharding.box(host_np.shape)],
                         mesh_device(sharding.mesh))


# ---------------------------------------------------- the sharded steps

def _specs(a_km: bool, b_nk: bool, c_nm: bool):
    return (("y", "x") if a_km else ("x", "y"),
            (None, "y") if b_nk else ("y", None),
            ("y", "x") if c_nm else ("x", "y"))


def _scatter_n(part: torch.Tensor, c_nm: bool, py: int) -> torch.Tensor:
    """The partial rearranged so the 'y' group's reduce-scatter hands rank
    yi the sum of column block yi of n: dim 1 of an (m, n) partial, dim 0
    of an (n, m) one (already in blocks)."""
    if c_nm or py == 1:
        return part
    m, n = part.shape
    return part.view(m, py, n // py).transpose(0, 1).reshape(py * m,
                                                             n // py)


def sharded_accum_step(mesh, prec: str = "highest", a_km: bool = False,
                       b_nk: bool = False, c_nm: bool = False):
    """step(c, a, b, alpha) on this rank's shards (`_specs`' layout, the
    storage layouts of ops/device.accum_step): K1 (`accum_matmul`,
    α = 1) into a zeroed partial, a reduce-scatter over 'y' along n, then
    c += alpha * the sum, in place.  Returns c."""
    from ..ops.matmul_cuda import accum_matmul
    px, py, _, _ = mesh_coords(mesh)
    y_group = mesh.get_group("y")

    def step(c_loc, a_loc, b_loc, alpha):
        n_full = c_loc.shape[0] * py if c_nm else c_loc.shape[1] * py
        m_loc = c_loc.shape[1] if c_nm else c_loc.shape[0]
        part = torch.zeros((n_full, m_loc) if c_nm else (m_loc, n_full),
                           dtype=c_loc.dtype, device=c_loc.device)
        accum_matmul(part, a_loc, b_loc, 1.0, a_km=a_km, b_nk=b_nk,
                     c_nm=c_nm, prec=prec)
        red = torch.empty_like(c_loc)
        reduce_scatter(red, _scatter_n(part, c_nm, py), y_group)
        return c_loc.add_(red.mul_(alpha))

    return step


def sharded_accum_step_q(mesh, a_km: bool = False, b_nk: bool = False,
                         c_nm: bool = False):
    """The int8 transfer mode's step(c, a, b, scale): K1 's8' with its
    int32 output gives each rank the exact int32 partial, the 'y' group
    sums them exactly in int32, then c += scale * f32(sum) in two fp32
    roundings (bof_tpu's multiply, then add)."""
    from ..ops.matmul_cuda import accum_matmul
    px, py, _, _ = mesh_coords(mesh)
    y_group = mesh.get_group("y")

    def step(c_loc, a_loc, b_loc, scale):
        n_full = c_loc.shape[0] * py if c_nm else c_loc.shape[1] * py
        m_loc = c_loc.shape[1] if c_nm else c_loc.shape[0]
        part = torch.zeros((n_full, m_loc) if c_nm else (m_loc, n_full),
                           dtype=torch.int32, device=c_loc.device)
        accum_matmul(part, a_loc, b_loc, 1.0, a_km=a_km, b_nk=b_nk,
                     c_nm=c_nm)
        red = torch.empty(c_loc.shape, dtype=torch.int32,
                          device=c_loc.device)
        reduce_scatter(red, _scatter_n(part, c_nm, py), y_group)
        return c_loc.add_(red.to(c_loc.dtype).mul_(float(scale)))

    return step


# -------------------------------------------------- the per-rank data plane

def _shard_subaccess(off: int, si, shp, s0: int, s1: int, t0: int, t1: int,
                     itemsize: int):
    """Byte access covering storage lines [s0,s1) x element columns
    [t0,t1) — shard coordinates of the PADDED (sb, sb) tile — within a
    whole-tile access (off, si) whose REAL storage shape is shp.
    Returns (sub_off, sub_si | None, lines, width): lines/width are the
    real element extents (the rest of the shard is zero padding); None
    when the shard lies entirely in padding."""
    from ..io.stride import StrideInfo

    lines = max(0, min(s1, shp[0]) - s0)
    width = max(0, min(t1, shp[1]) - t0)
    if lines == 0 or width == 0:
        return off, None, 0, 0
    # a contiguous whole-tile access packs shp[0] lines of shp[1] elems
    line_stride = si.stride if si.n_strides > 1 else shp[1] * itemsize
    sub_off = off + s0 * line_stride + t0 * itemsize
    return (sub_off,
            StrideInfo(stride=line_stride, n_strides=lines,
                       len_per_stride=width * itemsize),
            lines, width)


def _shard_read_plan(specs, sharding: Sharding, sb: int, itemsize: int,
                     flat_accesses: list):
    """Per-step shard plan of this rank: for every tile spec, (shard box,
    real lines/width, index into flat_accesses or None when the shard is
    pure padding).  Appends the shard sub-accesses to flat_accesses (a
    PrefetchSeq consumes them in order)."""
    rows, cols = sharding.box((sb, sb))
    s0, s1, t0, t1 = rows.start, rows.stop, cols.start, cols.stop
    plan = []
    for (store, off, si), shp in specs:
        sub_off, sub_si, lines, width = _shard_subaccess(
            off, si, shp, s0, s1, t0, t1, itemsize)
        pidx = None
        if sub_si is not None:
            pidx = len(flat_accesses)
            flat_accesses.append((store, sub_off, sub_si))
        plan.append(((s0, s1, t0, t1), lines, width, pidx))
    return plan


def _assemble_shards(entry, seq, dtype) -> np.ndarray:
    """This rank's shard of one tile from its pin-cache view, zero-padded
    to the shard box (the pin is released)."""
    (s0, s1, t0, t1), lines, width, pidx = entry
    shard = np.zeros((s1 - s0, t1 - t0), dtype)
    if pidx is not None:
        raw = seq.get(pidx).view(dtype)
        shard[:lines, :width] = raw.reshape(lines, width)
        seq.done(pidx)
    return shard


def _writeback_shards(c_loc: np.ndarray, c, i0: int, j0: int, bi: int,
                      bj: int, box):
    """Write this rank's shard `c_loc` (storage box `box` of the padded
    (sb, sb) storage-major C superblock at logical (i0, j0), real extent
    bi x bj) back to the store; returns the write tickets.  The storage
    axes are logical (row, col) for row-major C and swapped for
    column-major."""
    s0, s1, t0, t1 = box
    if c.order == "R":
        r0, r1 = i0 + s0, min(i0 + s1, i0 + bi)
        c0_, c1 = j0 + t0, min(j0 + t1, j0 + bj)
        nr, nc = r1 - r0, c1 - c0_
        if nr <= 0 or nc <= 0:
            return []
        data = c_loc[:nr, :nc]
    else:  # storage rows = logical cols for column-major C
        r0, r1 = i0 + t0, min(i0 + t1, i0 + bi)
        c0_, c1 = j0 + s0, min(j0 + s1, j0 + bj)
        nr, nc = r1 - r0, c1 - c0_
        if nr <= 0 or nc <= 0:
            return []
        data = c_loc[:nc, :nr]
    return [c.write_block_storage_async(r0, c0_, nr, nc,
                                        np.ascontiguousarray(data))]


def gemm_sharded(a, b, c, alpha: float = 1.0, beta: float = 0.0,
                 transa: str = "N", transb: str = "N",
                 blk: Optional[int] = None, mesh=None, ctx=None) -> None:
    """Multi-card out-of-core GEMM: ops/gemm.py's superblock pipeline
    (`_superblock_pipeline`) with every superblock sharded over the mesh.
    Its producer prefetches tiles through the pin cache and uploads this
    rank's shards `pipeline_depth` steps ahead, with a device LRU of B
    shards; the main thread launches the sharded steps; the writer writes
    this rank's C shards back.  All 8 {order}x{transA}x{transB} configs via
    storage-major blocks; float32 (with the transfer modes) and float64
    (K1 'f64' a shard)."""
    from ..context import get_context
    from ..core.flash_array import check_output_distinct
    from ..core.pipeline import PrefetchSeq, TicketWindow
    from ..io.native import quantize_amax
    from ..io.store import store_uid
    from ..ops import device as dev
    from ..ops.gemm import (BlockAccumulator, _check_finite, _check_slice,
                            _op_block_reader, _storage_shape,
                            _superblock_pipeline, _write_rows_async,
                            link_round, link_upload, pad_to, tile_extent)
    from ..utils import LOG, cdiv

    ctx = ctx or c.ctx or get_context()
    cfg = ctx.config
    mesh = mesh or make_mesh(device=cfg.device)
    device = mesh_device(mesh)
    if device.type != dev.resolve_device(cfg.device).type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the config's "
                         f"device is {cfg.device}")
    px, py, _, _ = mesh_coords(mesh)
    world = n_ranks(mesh)
    sb = blk or cfg.gemm_blk_size
    lcm = int(np.lcm(px, py))
    sb = max(lcm, (sb // lcm) * lcm)
    ta, tb = transa.upper() == "T", transb.upper() == "T"

    check_output_distinct(c, a=a, b=b)
    m, n = c.shape
    k = a.shape[0] if ta else a.shape[1]
    if (a.shape != ((k, m) if ta else (m, k))
            or b.shape != ((n, k) if tb else (k, n))):
        raise ValueError("operand shapes inconsistent with transposes")
    if not (a.dtype == b.dtype == c.dtype):
        raise ValueError("mixed dtypes not supported")
    _check_slice(cfg, c.dtype)
    sharded_reads = world > 1 or _FORCE_SHARDED_READS

    # tile-major operands: whole-tile reads only (a shard box is a
    # sub-tile region, which the tile-aligned access contract cannot serve)
    for nm_, arr_ in (("a", a), ("b", b), ("c", c)):
        t_ = getattr(arr_, "tile", None)
        if t_ is None:
            continue
        if t_ != sb:
            raise ValueError(
                f"operand {nm_} is tile-major with tile {t_}; "
                f"gemm_sharded blk resolved to {sb} (lcm-rounded to the "
                f"{px}x{py} mesh) — repack with tile={sb}")
        if sharded_reads:
            raise ValueError(
                "tile-major operands need whole-tile reads, which only a "
                "world of one rank makes; unpack to a flat layout first")
    c_tiled = getattr(c, "tile", None) is not None

    a_access, a_km = _op_block_reader(a, ta)
    b_access, b_nk = _op_block_reader(b, tb)
    c_nm = c.order == "C"
    xfer_mode = cfg.transfer_dtype
    xfer_bf16 = xfer_mode == "bfloat16"
    xfer_int8 = xfer_mode == "int8"
    a_spec, b_spec, c_spec = _specs(a_km, b_nk, c_nm)
    sh_a, sh_b, sh_c = (sharding_for(mesh, s) for s in (a_spec, b_spec,
                                                        c_spec))
    box_a, box_b, box_c = (sh.box((sb, sb)) for sh in (sh_a, sh_b, sh_c))

    mB, nB, kB = cdiv(m, sb), cdiv(n, sb), cdiv(k, sb)
    steps = [(i, j, l) for j in range(nB) for i in range(mB)
             for l in range(kB)]

    extent = functools.partial(tile_extent, sb, m, n, k)

    a_specs, b_specs = [], []
    for (i, j, l) in steps:
        bi, bj, bl = extent(i, j, l)
        (off, si), shp = a_access(i * sb, l * sb, bi, bl)
        a_specs.append(((a.store, off, si), shp))
        (off, si), shp = b_access(l * sb, j * sb, bl, bj)
        b_specs.append(((b.store, off, si), shp))

    # the two PrefetchSeqs pin 2*depth tiles up front and the backlog
    # services strictly FIFO: 2*depth + 2 tiles must fit the pin budget
    # (bof_tpu's clamp), and less than 4 tiles is a loud error
    tile_bytes = sb * sb * np.dtype(a.dtype).itemsize
    budget = cfg.program_budget
    if budget < 4 * tile_bytes:
        raise MemoryError(
            f"program_budget {budget} cannot hold the 4 superblocks "
            f"({4 * tile_bytes} B at blk={sb}) the sharded pipeline "
            "needs in flight; reduce blk or raise the budget")
    depth = max(1, min(cfg.pipeline_depth,
                       int((budget - 2 * tile_bytes) // (2 * tile_bytes))))
    cache = ctx.pin_cache()
    if cfg.debug_checks and c.dtype == np.float64:
        _check_finite(a, a_access, m, k, sb, cache)
        _check_finite(b, b_access, k, n, sb, cache)

    # device LRU of B shards: with steps ordered j-outer/i-middle/l-inner
    # the B superblock (l, j) recurs for every i.  B is sharded over 'y'
    # only, so a rank holds 1/py of a tile
    per_dev_tile = sb * sb * np.dtype(b.dtype).itemsize // max(py, 1)
    b_cap = max(1, min(kB, int(cfg.hbm_budget // 3 // max(per_dev_tile, 1))))

    itemsize = np.dtype(a.dtype).itemsize
    if sharded_reads:
        a_flat: list = []
        b_flat: list = []
        a_plan = _shard_read_plan(a_specs, sh_a, sb, itemsize, a_flat)
        b_plan = _shard_read_plan(b_specs, sh_b, sb, itemsize, b_flat)

    def read_shard(plan, idx, seq, dtype):
        """(this rank's shard of tile idx for the link, its scale)."""
        host = _assemble_shards(plan[idx], seq, dtype)
        amax = None
        if xfer_int8:  # the whole tile's max over every rank's shard
            (s0, s1, t0, t1), lines, width, _ = plan[idx]
            amax = host_max(quantize_amax(host[:lines, :width]))
        return link_round(host, xfer_mode, amax)

    def read_tile(seq, idx, dtype, shape, box):
        """(this rank's box of whole tile idx for the link, its scale)."""
        buf = seq.get(idx)
        host, scale = link_round(buf.view(dtype).reshape(shape), xfer_mode)
        host = pad_to(host, (sb, sb))[box]
        if dev.is_whole(host, buf):
            seq.lock(idx)  # it goes up as it stands: by DMA
        return host, scale

    def produce(put):
        seq_a = seq_b = None
        b_lru: dict = {}  # spec key -> device B shard (insert-ordered)
        try:
            if sharded_reads:
                seq_a = PrefetchSeq(cache, a_flat, depth)
                seq_b = PrefetchSeq(cache, b_flat, depth)
            else:
                seq_a = PrefetchSeq(cache, [s for s, _ in a_specs], depth)
                seq_b = PrefetchSeq(cache, [s for s, _ in b_specs], depth)
            for idx, (i, j, l) in enumerate(steps):
                bi, bj, bl = extent(i, j, l)
                c_init = None
                if l == 0 and beta != 0.0:
                    c_host = c.read_block_storage(i * sb, bi, j * sb, bj)
                    c_init = dev.to_device(pad_to(c_host, (sb, sb))[box_c],
                                           device)
                (b_store, b_off, b_si), b_shp = b_specs[idx]
                b_key = (store_uid(b_store), b_off, b_si)
                b_dev = b_lru.pop(b_key, None)  # pop+reinsert = LRU touch
                with METRICS.span("gemm_sharded.disk_wait"):
                    if sharded_reads:
                        a_host, sa = read_shard(a_plan, idx, seq_a, a.dtype)
                        if b_dev is None:
                            b_host, sb_s = read_shard(b_plan, idx, seq_b,
                                                      b.dtype)
                        else:
                            METRICS.add("gemm_sharded.b_hbm_hits")
                            pidx = b_plan[idx][3]
                            if pidx is not None:  # keep the seq in order
                                seq_b.get(pidx)
                                seq_b.done(pidx)
                    else:
                        a_host, sa = read_tile(seq_a, idx, a.dtype,
                                               a_specs[idx][1], box_a)
                        if b_dev is None:
                            b_host, sb_s = read_tile(seq_b, idx, b.dtype,
                                                     b_shp, box_b)
                        else:
                            seq_b.get(idx)  # keep the seq in lockstep
                            METRICS.add("gemm_sharded.b_hbm_hits")
                with METRICS.span("gemm_sharded.h2d") as sp:
                    a_up = link_upload(a_host, device, xfer_bf16)
                    a_dev = (a_up, sa) if xfer_int8 else a_up
                    sp.nbytes = a_up.nbytes
                    if b_dev is None:
                        b_up = link_upload(b_host, device, xfer_bf16)
                        b_dev = (b_up, sb_s) if xfer_int8 else b_up
                        sp.nbytes += b_up.nbytes
                if not sharded_reads:
                    seq_a.done(idx)
                    seq_b.done(idx)
                b_lru[b_key] = b_dev
                while len(b_lru) > b_cap:
                    b_lru.pop(next(iter(b_lru)))
                if not put((a_dev, b_dev, c_init)):
                    return
        finally:
            if seq_a is not None:
                seq_a.close()
            if seq_b is not None:
                seq_b.close()

    def write_all(blocks):
        tickets = TicketWindow(depth=8, span="gemm_sharded.write_wait")
        ring = ctx.d2h_ring(device)
        rows, cols = box_c
        with shard_writer(c, mesh) as c_w:
            try:
                for i, j, fin in blocks:
                    bi, bj, _ = extent(i, j, 0)
                    lines, width = ((sb, sb) if c_tiled
                                    else _storage_shape(c, (bi, bj)))
                    # this rank's shard of the block's real storage
                    # extent (all of it in a world of one rank)
                    n_rows = max(0, min(rows.stop, lines) - rows.start)
                    n_cols = max(0, min(cols.stop, width) - cols.start)

                    def write_run(r, host):
                        with METRICS.span("gemm_sharded.write"):
                            if sharded_reads:
                                s0 = rows.start + r
                                written = _writeback_shards(
                                    host, c_w, i * sb, j * sb, bi, bj,
                                    (s0, s0 + len(host), cols.start,
                                     cols.stop))
                            else:
                                written = [_write_rows_async(
                                    c_w, i * sb, j * sb, bi, bj, r, host)]
                        # a push may stall on the window's oldest disk
                        # write: gemm_sharded.write_wait
                        tickets.extend(written)
                        return written[0] if written else None

                    ring.download(fin, acc.finish, n_rows, n_cols,
                                  write_run, "gemm_sharded")
            finally:
                tickets.wait_all()  # no write may outlive c_w's store

    c_shape = tuple(s.stop - s.start for s in box_c)
    step = sharded_accum_step(mesh, cfg.matmul_precision, a_km=a_km,
                              b_nk=b_nk, c_nm=c_nm)
    step_q = (sharded_accum_step_q(mesh, a_km=a_km, b_nk=b_nk, c_nm=c_nm)
              if xfer_int8 else None)
    acc = BlockAccumulator(c_shape, device, c.dtype, alpha, beta, step,
                           step_q)

    m_before = METRICS.snapshot()
    with METRICS.span("gemm_sharded") as call:
        _superblock_pipeline(steps, kB, depth, produce, acc.start,
                             acc.accum, write_all, "gemm_sharded")
        c.store.flush()
        if world > 1:
            barrier()  # every rank's C shards are on disk
    wall = call.seconds
    m_after = METRICS.snapshot()
    busy = sum(m_after.get(key, 0.0) - m_before.get(key, 0.0)
               for key in ("gemm_sharded.disk_wait_s", "gemm_sharded.h2d_s",
                           "gemm_sharded.d2h_s"))
    LOG.info("gemm_sharded %dx%dx%d on %dx%d mesh: %.2fs wall, "
             "%.2fs producer+writer stage time (overlap factor %.2f)",
             m, n, k, px, py, wall, busy, busy / wall if wall else 0.0)
