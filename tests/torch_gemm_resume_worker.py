"""Worker of the port's gemm kill-and-resume test
(tests/test_torch_gemm_resume.py): one journaled out-of-core gemm of the
port over operand files the test wrote, on the CPU.  The test SIGKILLs
this process mid-run and starts it again; the second run must resume from
the journal and write a C byte-identical to an uninterrupted run.  It
imports bof_tpu_torch only.

Usage: torch_gemm_resume_worker.py <workdir> <n> <blk>
"""
import os
import sys

import numpy as np


def main() -> int:
    workdir, n, blk = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import bof_tpu_torch as bt
    from bof_tpu_torch.ops.gemm import gemm
    ctx = bt.FlashContext(bt.FlashConfig(
        device="cpu", scratch_dir=os.path.join(workdir, "scratch"),
        n_io_threads=2, n_compute_threads=1, pipeline_depth=2,
        program_budget=256 << 20))
    A, B = (bt.map_array(os.path.join(workdir, name), (n, n), np.float32,
                         "R", ctx=ctx) for name in ("A.bin", "B.bin"))
    C = bt.map_array(os.path.join(workdir, "C.bin"), (n, n), np.float32,
                     "R", create=True, ctx=ctx)
    gemm(A, B, C, blk=blk, ctx=ctx,
         resume_journal=os.path.join(workdir, "journal.txt"))
    ctx.destroy()
    print("GEMM_DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
