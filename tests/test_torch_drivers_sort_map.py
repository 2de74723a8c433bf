"""The port's sort and map/reduce CLI drivers on the CPU, as bof_tpu's
tests/test_drivers.py runs bof_tpu's (its cases at :94 and :260), with
`--device cpu`, each against bof_tpu's driver on the same file.

The drivers run in this process through their `main(argv)`.  Sort
outputs are bof_tpu's bit for bit; the float32 map (torch.sqrt against
bof_tpu's jnp.sqrt) within one unit in the last place, since torch's CPU
sqrt is not correctly rounded (on the card it is; chip_smoke.py holds it
bit for bit to np.sqrt); float64 sqrt exact and its sum within bof_tpu's
rtol 1e-12 of numpy's.
"""
import importlib

import numpy as np
import pytest


def run_driver(pkg, mod, *args, scratch=None):
    argv = [str(a) for a in args]
    if scratch is not None:
        argv += ["--scratch", scratch]
    if pkg == "bof_tpu_torch" and "--in-mem" not in argv:
        argv += ["--device", "cpu"]
    return importlib.import_module(f"{pkg}.drivers.{mod}").main(argv)


@pytest.fixture
def scratch(tmp_path):
    d = tmp_path / "scratch"
    d.mkdir()
    return str(d)


def test_sort_and_map_reduce_drivers(tmp_path, scratch, capsys):
    n = 40_000
    data = np.abs(np.random.default_rng(2).standard_normal(n)).astype(
        np.float32)
    d64 = np.abs(np.random.default_rng(3).standard_normal(n))
    out = {}
    for pkg in ("bof_tpu", "bof_tpu_torch"):
        src, dst = str(tmp_path / f"s_{pkg}"), str(tmp_path / f"d_{pkg}")
        data.tofile(src)
        run_driver(pkg, "sort", src, dst, n, "--blk", 4096,
                   scratch=f"{scratch}/{pkg}")
        m = str(tmp_path / f"m_{pkg}")
        run_driver(pkg, "map_reduce", src, m, n, scratch=f"{scratch}/{pkg}")
        assert "sum" in capsys.readouterr().out
        src64, out64 = str(tmp_path / f"s64_{pkg}"), str(tmp_path /
                                                          f"m64_{pkg}")
        d64.tofile(src64)
        run_driver(pkg, "map_reduce", src64, out64, n, "--dtype", "float64",
                   scratch=f"{scratch}/{pkg}")
        said = capsys.readouterr().out
        out[pkg] = (np.fromfile(dst, np.float32), np.fromfile(m, np.float32),
                    np.fromfile(out64, np.float64),
                    float(said.split("sum ")[1].split()[0]))
    ref, got = out["bof_tpu"], out["bof_tpu_torch"]
    np.testing.assert_array_equal(got[0], np.sort(data))
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  ref[0].view(np.uint32))
    np.testing.assert_array_max_ulp(got[1], ref[1], maxulp=1)
    np.testing.assert_allclose(got[2], np.sqrt(d64), rtol=0, atol=0)
    np.testing.assert_array_equal(got[2], ref[2])
    # block-sequential vs numpy-pairwise fp64 accumulation order
    np.testing.assert_allclose(got[3], np.sqrt(d64).sum(), rtol=1e-12)
    assert got[3] == ref[3]


def test_sort_and_kmeans_in_mem_baselines(tmp_path, scratch, capsys):
    n = 10_000
    src = str(tmp_path / "s")
    data = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    data.tofile(src)
    pts = str(tmp_path / "p")
    np.random.default_rng(8).standard_normal((500, 4)).astype(
        np.float32).tofile(pts)
    outs = {}
    for pkg in ("bof_tpu", "bof_tpu_torch"):
        dst = str(tmp_path / f"d_{pkg}")
        run_driver(pkg, "sort", src, dst, n, "--in-mem")
        run_driver(pkg, "kmeans", pts, 500, 4, 3, "--iters", 2, "--in-mem")
        said = capsys.readouterr().out
        assert "inertia" in said
        outs[pkg] = (np.fromfile(dst, np.float32),
                     float(said.split("inertia ")[1].split()[0]))
    np.testing.assert_array_equal(outs["bof_tpu_torch"][0], np.sort(data))
    np.testing.assert_array_equal(outs["bof_tpu_torch"][0].view(np.uint32),
                                  outs["bof_tpu"][0].view(np.uint32))
    assert outs["bof_tpu_torch"][1] == outs["bof_tpu"][1]
