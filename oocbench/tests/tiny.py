"""Shared pieces of the benchmark's CPU tests: tiny cells that drive the
whole of a run on the CPU (the port's plain kernels), with the card's
look skipped."""
import copy

DENSE = {"m": 64, "n": 48, "k": 1024, "order": "R", "transa": "N",
         "transb": "N", "alpha": 1.0, "beta": 0.0}
CSR = {"rows": 4096, "cols": 2048, "density": 0.01}
TINY = {
    "gemm": (DENSE, {"entry": "gemm", "program_budget_ratio": 0.5,
                     "flash_config": {"gemm_blk_size": 256}}),
    "csrgemv": (CSR, {"entry": "csrgemv", "program_budget_ratio": 0.42,
                      "flash_config": {"max_nnzs": 16384}}),
    "csrmm": (CSR, {"entry": "csrmm", "rhs_cols": 8,
                    "program_budget_ratio": 0.42,
                    "flash_config": {"max_nnzs": 16384}}),
}
# the committed cells' limits, one mix of each entry
LIMIT_OF = {"gemm": "flash", "csrgemv": "spmv", "csrmm": "project64"}


def tiny(entry):
    """(configuration, mix) of a tiny cell of `entry`, with the limit of
    the committed cell that runs it."""
    import json
    import os
    from oocbench import run as R
    config, mix = copy.deepcopy(TINY[entry])
    with open(os.path.join(R.HERE, "mixes",
                           LIMIT_OF[entry] + ".json")) as f:
        real = json.load(f)
    mix["limits"] = real["limits"]
    mix["control"] = real["control"]
    return config, mix


def run_tiny(entry, seed=2**31 + 77, seconds=0.5, trace=False,
             overrides=None):
    from oocbench import run as R
    config, mix = tiny(entry)
    rec = R.run(config, mix, seed, seconds,
                trace, device="cpu", overrides=overrides, log=lambda s: None)
    line = R.result_line(rec, [("gflops", "GFLOP/s")], {"platform": "cpu"},
                         trace)
    return rec, line


