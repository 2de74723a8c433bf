"""The float64 reference and the operand maker against direct NumPy at a
tiny size, and the reference's imports."""
import ast
import os

import numpy as np
import pytest
import torch

from oocbench import operands, reference, run as R


def test_gemm_rows_matches_numpy():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 300)).astype(np.float32)
    b = rng.standard_normal((300, 24)).astype(np.float32)
    rows = np.array([0, 7, 39, 12])
    got = reference.gemm_rows(torch.from_numpy(a), torch.from_numpy(b),
                              rows, alpha=-1.5).numpy()
    want = -1.5 * (a.astype(np.float64)[rows] @ b.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("rhs", [None, 1, 5])
def test_csr_rows_times_matches_numpy(rhs):
    import scipy.sparse as sps
    ia, ja, va = operands.csr_uniform(500, 300, 0.02, 99, 0, "cpu")
    sp = sps.csr_matrix((va.numpy().astype(np.float64), ja.numpy(),
                         ia.numpy()), shape=(500, 300))
    rng = np.random.default_rng(1)
    shape = (300,) if rhs is None else (300, rhs)
    b = rng.standard_normal(shape).astype(np.float32)
    full = sp @ b.astype(np.float64)
    got = reference.csr_rows_times(ia, ja, va, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-12, atol=1e-12)
    rows = np.array([3, 0, 499, 250])
    got = reference.csr_rows_times(ia, ja, va, torch.from_numpy(b),
                                   rows).numpy()
    np.testing.assert_allclose(got, full[rows], rtol=1e-12, atol=1e-12)


def test_csr_uniform_is_a_sorted_csr_at_its_density():
    m, k, s = 2000, 1000, 0.01
    ia, ja, va = operands.csr_uniform(m, k, s, 2**40 + 3, 0, "cpu")
    ia, ja = ia.numpy(), ja.numpy()
    assert ia[0] == 0 and (np.diff(ia) >= 0).all() and ia[-1] == len(ja)
    assert len(va) == len(ja)
    assert 0 <= ja.min() and ja.max() < k
    for r in range(0, m, 97):
        assert (np.diff(ja[ia[r]:ia[r + 1]]) >= 0).all()
    assert abs(ia[-1] / (m * k) - s) < 0.1 * s


def test_same_seed_same_operands_other_seed_other():
    a = operands.normals((4, 5), 2**33 + 1, 0, "cpu")
    assert torch.equal(a, operands.normals((4, 5), 2**33 + 1, 0, "cpu"))
    assert not torch.equal(a, operands.normals((4, 5), 2**33 + 2, 0, "cpu"))
    assert not torch.equal(a, operands.normals((4, 5), 2**33 + 1, 1, "cpu"))


def test_write_raw_round_trip(tmp_path):
    x = torch.arange(3 * 4099, dtype=torch.float32).reshape(3, 4099)
    p = str(tmp_path / "x.f32")
    assert operands.write_raw(p, x) == x.numel() * 4
    assert os.path.getsize(p) == x.numel() * 4
    np.testing.assert_array_equal(np.fromfile(p, np.float32),
                                  x.numpy().ravel())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_jax_nor_either_package():
    ref = os.path.join(R.HERE, "reference")
    files = [os.path.join(ref, f) for f in os.listdir(ref)
             if f.endswith(".py")]
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "bof_tpu", "bof_tpu_torch"), f
