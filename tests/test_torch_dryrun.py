"""bof_tpu_torch.dryrun, the port of __graft_entry__.py: `entry()`'s
superblock K loop against the reference's jitted on the JAX CPU backend,
and `dryrun_multichip` in-process on one rank, on four gloo ranks (a 2 x 2
mesh) that it starts itself, and refusing a card it does not have."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("TP gemm step", "DP Lloyd step",
          "pipelined out-of-core gemm_sharded", "row-sharded csrmm_sharded",
          "sharded one-pass AtA operator", "mesh-sharded fp64 gemm",
          "sharded block-Lanczos SVD app")


def _graft_entry():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import __graft_entry__
    return __graft_entry__


def _all_phases_passed(out: str, n: int, mesh: str) -> None:
    for name in PHASES:
        assert f"[dryrun] phase '{name}" in out, (name, out)
    assert f"dryrun_multichip OK on {n} cpu rank(s) (mesh {mesh}" in out, out


def test_entry_matches_graft_entry():
    """The same example arguments (seed 0, 256 x 256 tiles, 2 k-tiles) and
    the same C, rtol 2e-4 with the repo's fp32 atol (1e-5 * sqrt(k) *
    max|A| * max|B|), against the reference's function jitted on the JAX
    CPU backend; the port's function leaves its arguments unchanged."""
    import jax

    from bof_tpu_torch.dryrun import entry
    ref_fn, ref_args = _graft_entry().entry()
    fn, args = entry(device="cpu")
    assert len(args) == len(ref_args) == 4
    for got, want in zip(args[:3], ref_args[:3]):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    assert float(args[3]) == float(ref_args[3])
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    got = fn(*args).numpy()
    k = args[1].shape[0] * args[1].shape[2]
    atol = 1e-5 * np.sqrt(k) * np.abs(ref_args[1]).max() \
        * np.abs(ref_args[2]).max()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol)
    assert not args[0].any(), "fn must not write its C argument"


def test_dryrun_one_rank_in_process(capsys):
    from bof_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(1, device="cpu")
    _all_phases_passed(capsys.readouterr().out, 1, "1x1")
    assert not dist.is_initialized(), "the world it made must be gone"


def test_dryrun_on_four_gloo_ranks(capsys):
    from bof_tpu_torch.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu", timeout=110)
    _all_phases_passed(capsys.readouterr().out, 4, "2x2")


def test_dryrun_in_a_group_of_another_size_raises():
    from torch_dist_pool import one_rank_world

    from bof_tpu_torch.dryrun import dryrun_multichip
    with one_rank_world():
        with pytest.raises(ValueError, match="process group of 1 rank"):
            dryrun_multichip(2, device="cpu")


def test_dryrun_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "bof_tpu_torch.dryrun", "1",
                          "--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    _all_phases_passed(out.stdout, 1, "1x1")


def test_dryrun_for_cards_the_machine_lacks_raises():
    from bof_tpu_torch.dryrun import dryrun_multichip, entry
    if torch.cuda.is_available():
        have = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"needs {have + 1} cards"):
            dryrun_multichip(have + 1)
        return
    with pytest.raises(RuntimeError, match="0 cards for 2 rank"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="0 cards for 1 rank"):
        dryrun_multichip(1, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    assert not dist.is_initialized()
