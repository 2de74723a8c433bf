"""The port's superblock-granular gemm resume (`ops/gemm.py`'s
`resume_journal`) against bof_tpu's, case for case after
tests/test_gemm_resume.py: a journaled gemm of the port killed with SIGKILL
mid-run (tests/torch_gemm_resume_worker.py, on the CPU) resumes by
skipping exactly the C superblocks whose bytes are durable, and its C is
byte-identical to an uninterrupted run of the port and within fp32's
tolerance of bof_tpu's; torn journal lines and the journal's guards behave
as bof_tpu's do."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_pair import BOTH, REF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_gemm_resume_worker.py")
N, BLK = 512, 64  # 8 x 8 C superblocks, 8-step K chains


def _launch(workdir):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    return subprocess.Popen([sys.executable, WORKER, workdir, str(N),
                             str(BLK)], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _journal_data_lines(path):
    try:
        with open(path) as f:
            return max(0, sum(1 for _ in f) - 1)  # minus the header
    except OSError:
        return 0


def test_gemm_kill_and_resume(tmp_path):
    ref_dir, kill_dir = str(tmp_path / "ref"), str(tmp_path / "kill")
    os.makedirs(ref_dir)
    os.makedirs(kill_dir)
    rng = np.random.default_rng(42)
    for name in ("A.bin", "B.bin"):
        x = rng.standard_normal((N, N)).astype(np.float32)
        for d in (ref_dir, kill_dir):  # the same operand bytes in both
            x.tofile(os.path.join(d, name))

    p = _launch(ref_dir)  # the uninterrupted run, same worker
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0 and "GEMM_DONE" in out, out

    journal = os.path.join(kill_dir, "journal.txt")
    p = _launch(kill_dir)
    deadline = time.time() + 240
    try:  # SIGKILL once >= 2 superblocks are journaled durable
        while time.time() < deadline and p.poll() is None:
            if _journal_data_lines(journal) >= 2:
                break
            time.sleep(0.002)
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
        p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    done_at_kill = _journal_data_lines(journal)
    assert p.returncode == -signal.SIGKILL, (
        f"the worker ended before the kill (rc {p.returncode})")
    assert 1 <= done_at_kill < 64, done_at_kill

    p = _launch(kill_dir)  # resume: skip the journaled blocks, finish
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0 and "GEMM_DONE" in out, out
    assert not os.path.exists(journal), "journal must be removed on success"

    got = np.fromfile(os.path.join(kill_dir, "C.bin"), np.float32)
    want = np.fromfile(os.path.join(ref_dir, "C.bin"), np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    a, b = (np.fromfile(os.path.join(ref_dir, n), np.float32).reshape(N, N)
            for n in ("A.bin", "B.bin"))
    gold = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got.reshape(N, N), gold, rtol=2e-4,
                               atol=1e-3)
    ctx = REF.context(tmp_path / "bof_tpu_scratch")
    try:  # bof_tpu's gemm on the same files
        A, B = (REF.bt.map_array(os.path.join(ref_dir, n), (N, N),
                                 np.float32, "R", ctx=ctx)
                for n in ("A.bin", "B.bin"))
        C = REF.bt.mem_array((N, N), np.float32, ctx=ctx)
        REF.mod("ops.gemm").gemm(A, B, C, blk=BLK, ctx=ctx)
        np.testing.assert_allclose(got.reshape(N, N), C.read_all(),
                                   rtol=2e-4, atol=1e-3)
    finally:
        ctx.destroy()


def test_journal_torn_lines_ignored(tmp_path):
    """Only a line with its newline intact marks a superblock done: '12 3'
    torn from '12 34' is ignored, in both packages."""
    jp = str(tmp_path / "j.txt")
    for text, want in (("HDR\n0 1\n2 3\n12 3", {(0, 1), (2, 3)}),
                       ("HDR\n0 1\n2", {(0, 1)})):
        with open(jp, "w") as f:
            f.write(text)
        got = [pk.mod("ops.gemm")._load_journal(jp, "HDR") for pk in BOTH]
        assert got[0] == got[1] == want


def test_resume_journal_guards(tmp_path):
    """beta != 0 and a journal of another problem raise the same errors in
    both packages, whose headers name a problem alike; a journaled run
    that completes removes its journal and is right."""
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((64, 64)).astype(np.float32)
    results, headers = [], []
    for pk in BOTH:
        gemm_mod = pk.mod("ops.gemm")
        headers.append(gemm_mod._journal_header(
            64, 64, 64, 1.0, 0.0, "N", "N", 32, np.float32, "float32"))
        ctx = pk.context(tmp_path / f"{pk.name}_scratch")
        try:
            A = pk.bt.mem_array((64, 64), np.float32, data=a_np, ctx=ctx)
            C = pk.bt.mem_array((64, 64), np.float32, ctx=ctx)
            jp = str(tmp_path / f"{pk.name}_j.txt")
            with pytest.raises(ValueError, match="beta"):
                gemm_mod.gemm(A, A, C, beta=0.5, blk=32, ctx=ctx,
                              resume_journal=jp)
            with open(jp, "w") as f:
                f.write('{"some": "other problem"}\n0 0\n')
            with pytest.raises(ValueError, match="different gemm call"):
                gemm_mod.gemm(A, A, C, blk=32, ctx=ctx, resume_journal=jp)
            os.unlink(jp)
            gemm_mod.gemm(A, A, C, blk=32, ctx=ctx, resume_journal=jp)
            assert not os.path.exists(jp), pk
            results.append(C.read_all())
        finally:
            ctx.destroy()
    assert headers[0] == headers[1]
    want = (a_np.astype(np.float64) @ a_np).astype(np.float32)
    np.testing.assert_allclose(results[1], want, rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(results[1], results[0], rtol=2e-4, atol=1e-3)
