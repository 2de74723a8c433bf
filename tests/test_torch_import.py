"""The port's package boundary: bof_tpu_torch imports torch and never jax
or bof_tpu, asks for its device explicitly, and carries bof_tpu's
configuration across field for field."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bof_tpu
import bof_tpu_torch
from bof_tpu_torch.ops.matmul_cuda import accum_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bof_tpu_torch")


def test_import_leaves_jax_and_bof_tpu_out():
    code = ("import sys, bof_tpu_torch, bof_tpu_torch.drivers.gemm; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'bof_tpu' or "
            "m.startswith('bof_tpu.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_import_neither_jax_nor_bof_tpu():
    pat = re.compile(r"^\s*(from|import)\s+(jax|bof_tpu)(\.|\s|$)")
    hits = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for no, line in enumerate(f, 1):
                        if pat.match(line):
                            hits.append(f"{path}:{no}: {line.strip()}")
    assert hits == []


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    cfg = bof_tpu_torch.FlashConfig(device="cuda",
                                    scratch_dir=str(tmp_path / "s"))
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx,
                                    data=np.eye(8, dtype=np.float32))
        c = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            bof_tpu_torch.gemm(a, a, c, blk=4, ctx=ctx)
        assert not c.read_all().any(), "nothing may run on the CPU instead"
    finally:
        ctx.destroy()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((5, 7), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((7, 3), dtype=np.float32))
    c = torch.zeros(5, 3)
    before = accum_matmul.launches
    accum_matmul(c, a, b, 2.0, a_km=False, b_nk=False, c_nm=False)
    assert accum_matmul.launches == before
    np.testing.assert_allclose(c.numpy(), 2.0 * (a @ b).numpy(),
                               rtol=1e-6)


def test_config_from_reference_carries_every_shared_field():
    ref = bof_tpu.FlashConfig(program_budget=123 << 20, gemm_blk_size=64,
                              hbm_budget=5 << 20, pipeline_depth=2,
                              use_o_direct=True, io_backend="python",
                              matmul_precision="high")
    d = dataclasses.asdict(ref)
    port = bof_tpu_torch.config_from_reference(d, device="cpu")
    assert port.device == "cpu"
    port_d = dataclasses.asdict(port)
    dropped = {"device_compute", "fp64_device", "fp64_slices", "gemm_tile"}
    assert set(d) - set(port_d) == dropped
    for key in set(d) - dropped:
        assert port_d[key] == d[key], key
    with pytest.raises(KeyError, match="no_such_field"):
        bof_tpu_torch.config_from_reference(dict(d, no_such_field=1))


def test_native_engine_builds_outside_the_reference_package():
    from bof_tpu_torch.io import native
    lib = native.load_library()
    assert lib is not None
    so = native._build()
    assert so.startswith(native.build_root() + os.sep)
    assert "bof_tpu" + os.sep + "native" not in so
    assert os.path.basename(so).startswith("libbof_io-")


def _reference_lines(lines):
    """The lines of a port's native source that are the reference's: those
    of the pin cache's `read_bytes` counter and of the port's additions
    (a line marked `// port`, a block from `// port {` to `// port }`)
    taken out."""
    kept, block = [], False
    for x in lines:
        if b"// port {" in x:
            block = True
        elif b"// port }" in x:
            block = False
        elif not block and b"read_bytes" not in x and b"// port" not in x:
            kept.append(x)
    return b"".join(kept)


def test_native_engine_source_is_the_ports_own_copy():
    """The engine builds from sources inside bof_tpu_torch/, which are
    the reference's, byte for byte, but for the pin cache's `read_bytes`
    counter and the port's marked additions (page-locking): those taken
    out, the port's bof_cache.inc is the reference's."""
    from bof_tpu_torch.io import native
    ref_dir = os.path.join(REPO, "bof_tpu", "native")
    for path in (native._SRC, native._INC):
        assert os.path.realpath(path).startswith(
            os.path.realpath(PKG) + os.sep), path
        with open(path, "rb") as f, open(os.path.join(
                ref_dir, os.path.basename(path)), "rb") as g:
            ref = g.read()
            assert b"// port" not in ref
            assert _reference_lines(f.read().splitlines(keepends=True)) \
                == ref, path


def test_sparse_slice_imports_neither_jax_nor_ml_dtypes():
    code = ("import sys, bof_tpu_torch.sparse, bof_tpu_torch.drivers.csrmm, "
            "bof_tpu_torch.drivers.csrgemv, bof_tpu_torch.drivers.csrcsc, "
            "bof_tpu_torch.drivers.sparse_create, "
            "bof_tpu_torch.drivers.in_mem_sparse; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    pat = re.compile(r"^\s*(from|import)\s+ml_dtypes(\.|\s|$)")
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert not any(pat.match(line) for line in f), name


@pytest.mark.parametrize("kernel", ["csrmm", "csrgemv"])
def test_sparse_cuda_device_without_card_raises(tmp_path, kernel):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    import scipy.sparse as sps
    cfg = bof_tpu_torch.FlashConfig(device="cuda",
                                    scratch_dir=str(tmp_path / "s"))
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(
            sps.identity(8, dtype=np.float32, format="csr"), ctx=ctx)
        b = bof_tpu_torch.mem_array((8, 4), np.float32, ctx=ctx,
                                    data=np.ones((8, 4), np.float32))
        c = bof_tpu_torch.mem_array((8, 4), np.float32, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            if kernel == "csrmm":
                bof_tpu_torch.csrmm(a, b, c, ctx=ctx)
            else:
                bof_tpu_torch.csrgemv(a, np.ones(8, np.float32), ctx=ctx)
        assert not c.read_all().any(), "nothing may run on the CPU instead"
    finally:
        ctx.destroy()


def test_config_round_trips_non_default_sparse_fields():
    ref = bof_tpu.FlashConfig(max_nnzs=12345, csrmm_cblk_size=96,
                              csrgemv_blk_size=777, sparse_compute="host",
                              sparse_device_impl="pallas",
                              ell_sort_rows=False, ell_idx_narrow=False)
    port = bof_tpu_torch.config_from_reference(dataclasses.asdict(ref))
    for key in ("max_nnzs", "csrmm_cblk_size", "csrgemv_blk_size",
                "sparse_compute", "sparse_device_impl", "ell_sort_rows",
                "ell_idx_narrow"):
        assert getattr(port, key) == getattr(ref, key), key
    assert port.device == "cuda"  # never inferred from the reference


def test_dense_and_kmeans_slice_imports_neither_jax_nor_bof_tpu():
    code = ("import sys, bof_tpu_torch.ops.gemm64, bof_tpu_torch.ops.kmeans, "
            + ", ".join(f"bof_tpu_torch.drivers.{m}" for m in (
                "dense_create", "repack", "in_mem_gemm", "gemm_run",
                "mmap_gemm", "file_handle_test", "kmeans"))
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for name in ("gemm64", "kmeans_fit", "lloyds_iter", "repack", "unpack"):
        assert name in bof_tpu_torch.__all__
        assert getattr(bof_tpu_torch, name).__name__ == name


def test_new_kernel_sources_are_built_and_in_the_digest(tmp_path):
    """csrc/matmul_f64.cu (K1 'f64') and csrc/kmeans.cu (B7) are among the
    sources the build compiles, their entry points are bound, and a change
    to either changes the library's digest (so it rebuilds)."""
    import glob
    import shutil
    from bof_tpu_torch.ops import cuda_lib
    sources = sorted(glob.glob(os.path.join(cuda_lib._CSRC, "*.cu")))
    names = {os.path.basename(p) for p in sources}
    assert {"matmul_f64.cu", "kmeans.cu"} <= names
    for entry in ("bof_accum_matmul_f64", "bof_lloyd_assign",
                  "bof_lloyd_accumulate"):
        assert entry in cuda_lib._ENTRIES
    base = cuda_lib._digest(sources)
    for name in ("matmul_f64.cu", "kmeans.cu"):
        copy = [str(tmp_path / os.path.basename(p)) for p in sources]
        for src, dst in zip(sources, copy):
            shutil.copyfile(src, dst)
        with open(tmp_path / name, "a") as f:
            f.write("\n// changed\n")
        assert cuda_lib._digest(copy) != base, name


def test_apps_slice_imports_neither_jax_nor_bof_tpu():
    """The applications, their drivers and B8's wrapper import no jax,
    ml_dtypes or bof_tpu module; the package root exports bof_tpu's app
    names, and bof_tpu_torch.apps all seven, and the port's own addition,
    the operator both solvers call (`apply_gram`), from both."""
    code = ("import sys, bof_tpu_torch.apps, bof_tpu_torch.ops.topk_cuda, "
            + ", ".join(f"bof_tpu_torch.drivers.{m}" for m in (
                "eigensolver", "xml_rank", "topic_model"))
            + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    import bof_tpu_torch.apps as apps
    assert sorted(apps.__all__) == sorted(bof_tpu.apps.__all__
                                          + ["apply_gram"])
    for name in apps.__all__:
        assert getattr(apps, name).__name__ == name
    for name in ("apply_gram", "block_lanczos_svd", "block_power_svd",
                 "topic_model", "xml_rank"):
        assert name in bof_tpu_torch.__all__
        assert getattr(bof_tpu_torch, name) is getattr(apps, name)


@pytest.mark.parametrize("app", ["block_lanczos_svd", "xml_rank",
                                 "topic_model"])
def test_apps_cuda_device_without_card_raises(tmp_path, app):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    import scipy.sparse as sps
    cfg = bof_tpu_torch.FlashConfig(device="cuda",
                                    scratch_dir=str(tmp_path / "s"))
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(
            sps.random(40, 24, density=0.2, format="csr", dtype=np.float32,
                       random_state=np.random.RandomState(0)), ctx=ctx)
        w = bof_tpu_torch.mem_array((10, 24), np.float32, ctx=ctx,
                                    data=np.ones((10, 24), np.float32))
        s = bof_tpu_torch.mem_array((40, 3), np.float32, ctx=ctx)
        with pytest.raises(RuntimeError, match="cuda"):
            if app == "block_lanczos_svd":
                bof_tpu_torch.block_lanczos_svd(a, 3, ctx=ctx)
            elif app == "xml_rank":
                bof_tpu_torch.xml_rank(a, w, 3, scores_out=s, ctx=ctx)
            else:
                bof_tpu_torch.topic_model(a, 3, proj_dim=4, ctx=ctx)
        assert not s.read_all().any(), "nothing may run on the CPU instead"
    finally:
        ctx.destroy()


def test_topk_source_is_built_and_bound():
    """csrc/topk.cu (B8) is among the sources the build compiles and its
    entry point is bound, the stream last."""
    import glob
    from bof_tpu_torch.ops import cuda_lib
    names = {os.path.basename(p)
             for p in glob.glob(os.path.join(cuda_lib._CSRC, "*.cu"))}
    assert "topk.cu" in names
    assert cuda_lib._ENTRIES["bof_row_topk"][-1] is cuda_lib._P  # stream


def test_sort_map_slice_imports_neither_jax_nor_bof_tpu():
    """The sort, map/reduce and lib-func modules, their drivers and B10's
    wrapper import no jax, ml_dtypes or bof_tpu module; the package root
    exports every name bof_tpu's root does, as ops/ does bof_tpu.ops's, each
    bound to the port's own function."""
    code = ("import sys, bof_tpu_torch.ops.sort, bof_tpu_torch.ops.map_reduce,"
            " bof_tpu_torch.ops.sort_cuda, bof_tpu_torch.lib_funcs, "
            "bof_tpu_torch.types, bof_tpu_torch.utils.hostpar, "
            "bof_tpu_torch.drivers.sort, bof_tpu_torch.drivers.map_reduce; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    assert set(bof_tpu.__all__) <= set(bof_tpu_torch.__all__)
    for name in bof_tpu.__all__:
        obj = getattr(bof_tpu_torch, name)
        assert obj.__module__.split(".")[0] == "bof_tpu_torch", name
    import bof_tpu_torch.ops as ops
    assert sorted(ops.__all__) == sorted(bof_tpu.ops.__all__)
    for name in ("bof_sort", "bof_map", "bof_reduce"):
        assert getattr(ops, name) is getattr(bof_tpu_torch, name)


def test_b10_source_is_built_and_bound():
    """csrc/sort.cu (B10) is among the sources the build compiles, in the
    digest, and its entry points are bound; its wrapper counts launches."""
    import glob
    from bof_tpu_torch.ops import cuda_lib, sort_cuda
    sources = [os.path.basename(p) for p in
               glob.glob(os.path.join(cuda_lib._CSRC, "*.cu"))]
    assert "sort.cu" in sources
    assert "bof_sort_block" in cuda_lib._ENTRIES
    assert "bof_sort_block_scratch_ints" in cuda_lib._SIZES
    before = sort_cuda.sort_block.launches
    x = torch.tensor([3, -1, 2], dtype=torch.int32)
    got = sort_cuda.sort_block(x, np.int32)
    assert got.tolist() == [-1, 2, 3]
    assert sort_cuda.sort_block.launches == before  # CPU: plain version


def test_parallel_slice_imports_neither_jax_nor_bof_tpu():
    """parallel/ and utils/profiling import no jax, ml_dtypes or bof_tpu
    module; parallel/ exports bof_tpu.parallel's ten names, and they and
    profiling's trace/annotate keep bof_tpu's parameters (make_mesh adds a
    keyword-only `device`)."""
    import inspect
    code = ("import sys, bof_tpu_torch.parallel, bof_tpu_torch.parallel.mesh,"
            " bof_tpu_torch.utils.profiling, bof_tpu_torch.drivers.gemm; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    import bof_tpu.parallel
    import bof_tpu.utils.profiling as ref_prof
    import bof_tpu_torch.parallel as par
    import bof_tpu_torch.utils.profiling as prof
    assert sorted(par.__all__) == sorted(bof_tpu.parallel.__all__)
    pairs = [(getattr(par, n), getattr(bof_tpu.parallel, n))
             for n in par.__all__]
    pairs += [(prof.trace, ref_prof.trace), (prof.annotate, ref_prof.annotate)]
    for mine, ref in pairs:
        got = list(inspect.signature(mine).parameters)
        want = list(inspect.signature(ref).parameters)
        assert got[:len(want)] == want, mine.__name__
        assert got[len(want):] in ([], ["device"]), mine.__name__


@pytest.mark.parametrize("entry", ["make_mesh", "gemm_sharded",
                                   "csrmm_sharded", "kmeans_fit_sharded",
                                   "lloyds_iter_ooc_sharded", "gemm64_mesh"])
def test_parallel_cuda_device_without_card_raises(tmp_path, entry):
    """Every sharded entry point runs on the card unless asked for the CPU:
    with a cuda config and no card it raises before any process group or
    computation exists, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CPU-only contract does "
                    "not apply")
    import scipy.sparse as sps
    import torch.distributed as dist
    from bof_tpu_torch import parallel
    cfg = bof_tpu_torch.FlashConfig(device="cuda",
                                    scratch_dir=str(tmp_path / "s"))
    ctx = bof_tpu_torch.FlashContext(cfg)
    try:
        x = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx,
                                    data=np.eye(8, dtype=np.float32))
        c = bof_tpu_torch.mem_array((8, 8), np.float32, ctx=ctx)
        x64, c64 = (bof_tpu_torch.mem_array((8, 8), np.float64, ctx=ctx,
                                            data=np.eye(8))
                    for _ in range(2))
        a = bof_tpu_torch.CsrFlashMatrix.from_scipy(
            sps.identity(8, dtype=np.float32, format="csr"), ctx=ctx)
        labels = bof_tpu_torch.mem_array((8,), np.int32, ctx=ctx)
        calls = {
            "make_mesh": lambda: parallel.make_mesh(device=cfg.device),
            "gemm_sharded": lambda: parallel.gemm_sharded(x, x, c, ctx=ctx),
            "csrmm_sharded": lambda: parallel.csrmm_sharded(a, x, c,
                                                            ctx=ctx),
            "kmeans_fit_sharded": lambda: parallel.kmeans_fit_sharded(
                x, 2, labels_out=labels, ctx=ctx),
            "lloyds_iter_ooc_sharded": lambda: (
                parallel.lloyds_iter_ooc_sharded(
                    x, np.eye(2, 8, dtype=np.float32), labels_out=labels,
                    ctx=ctx)),
            "gemm64_mesh": lambda: bof_tpu_torch.gemm64(
                x64, x64, c64, ctx=ctx, mesh=parallel.make_mesh(
                    device=cfg.device))}
        with pytest.raises(RuntimeError, match="cuda"):
            calls[entry]()
        assert not dist.is_initialized()
        assert not c.read_all().any() and not labels.read_all().any()
    finally:
        ctx.destroy()


def test_dryrun_imports_neither_jax_nor_bof_tpu():
    """bof_tpu_torch.dryrun (the port of __graft_entry__.py) stands alone:
    importing it and building entry()'s function leaves jax, ml_dtypes
    and bof_tpu out."""
    code = ("import sys, bof_tpu_torch.dryrun as d; fn, args = "
            "d.entry(device='cpu'); fn(*args); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'bof_tpu', '__graft_entry__')); "
            "print(bad)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
