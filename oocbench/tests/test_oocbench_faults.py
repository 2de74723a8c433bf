"""`correct` comes out false when the timed path is broken underneath
(each fault a cell can have on one card: a call that leaves its output
as it was, one that hands back an earlier call's answer, half of the
work left out, an answer altered where it is produced), and under the
control, the next precision down."""
import importlib

import pytest

from oocbench.tests.tiny import run_tiny


def _every_other(fn):
    state = {"n": 0}

    def skip_half(*args, **kw):
        state["n"] += 1
        if state["n"] % 2:
            return fn(*args, **kw)
        return args[0]
    return skip_half


def _fault(monkeypatch, entry, kind):
    import bof_tpu_torch
    from bof_tpu_torch.ops import device as dev
    from bof_tpu_torch.sparse import spmm_device as sdev
    if kind == "replayed" and entry != "csrgemv":
        # a result cache: the first call's C (the warm-up's) is kept and
        # written back over C by every later call instead of computing
        real = getattr(bof_tpu_torch, entry)
        kept = {}

        def replay(a, b, c, *args, **kw):
            if "c" not in kept:
                real(a, b, c, *args, **kw)
                kept["c"] = c.read_all()
            else:
                c.write_block(0, kept["c"])
        monkeypatch.setattr(bof_tpu_torch, entry, replay)
    elif kind in ("unchanged", "replayed"):
        if entry == "csrgemv":
            # hands back the last call's y for this call's x
            last = {}
            real = bof_tpu_torch.csrgemv

            def stale(a, x, trans="N", ctx=None):
                if "y" not in last:
                    last["y"] = real(a, x, trans, ctx=ctx)
                return last["y"]
            monkeypatch.setattr(bof_tpu_torch, entry, stale)
        else:
            monkeypatch.setattr(bof_tpu_torch, entry,
                                lambda *a, **k: None)
    elif kind == "half":
        # every other device step (a K step of gemm, a row block's band
        # products of the sparse entries) is skipped
        if entry == "gemm":
            monkeypatch.setattr(dev, "accum_step",
                                _every_other(dev.accum_step))
        elif entry == "csrgemv":
            monkeypatch.setattr(sdev, "spmv_ell_block",
                                _every_other(sdev.spmv_ell_block))
        else:
            mod = importlib.import_module("bof_tpu_torch.sparse.csrmm")
            monkeypatch.setattr(mod, "spmm_bands",
                                _every_other(mod.spmm_bands))
    elif kind == "altered":
        if entry == "gemm":
            real = dev.accum_step

            def off(c, a, b, alpha, **kw):
                return real(c, a, b, alpha * 1.001, **kw)
            monkeypatch.setattr(dev, "accum_step", off)
        elif entry == "csrgemv":
            real = sdev.spmv_ell_block

            def off(x, ja, va, **kw):
                out = real(x, ja, va, **kw)
                out[kw["rows"].long()] *= 1.001
                return out
            monkeypatch.setattr(sdev, "spmv_ell_block", off)
        else:
            mod = importlib.import_module("bof_tpu_torch.sparse.csrmm")
            real = mod.spmm_bands

            def off(b_panel, bands, buf, alpha=1.0, **kw):
                return real(b_panel, bands, buf, alpha=alpha * 1.001, **kw)
            monkeypatch.setattr(mod, "spmm_bands", off)


@pytest.mark.parametrize("entry", ["gemm", "csrgemv", "csrmm"])
@pytest.mark.parametrize("kind", ["unchanged", "replayed", "half",
                                  "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, entry, kind):
    _fault(monkeypatch, entry, kind)
    rec, line = run_tiny(entry)
    assert rec["attempted"] >= 1
    assert line["correct"] is False, rec["checks"]


@pytest.mark.parametrize("entry", ["gemm", "csrgemv", "csrmm"])
def test_bf16_values_fail_the_limit(entry):
    """The sparse cells' control (bf16 values on the link); for the dense
    ones a step below their own control (K1's one TF32 pass runs only on
    the card)."""
    rec, line = run_tiny(entry, overrides={"transfer_dtype": "bfloat16"})
    assert line["correct"] is False
    assert rec["checks"]["rel_err"]["value"] > \
        rec["checks"]["rel_err"]["limit"]


@pytest.mark.cuda
def test_the_dense_control_fails_on_the_card(cuda_card):
    """The dense cells' control, K1 at one TF32 pass, at a size a test run
    holds (the plain version on the CPU computes full fp32 at every
    precision, so this one needs the card)."""
    from oocbench import run as R
    from oocbench.tests.tiny import tiny
    config, mix = tiny("gemm")
    config = dict(config, m=512, n=512, k=16384)
    mix = dict(mix, flash_config={"gemm_blk_size": 4096})
    rec = R.run(config, mix, 2**31 + 3, 1.0, False, device="cuda",
                overrides=mix["control"], log=lambda s: None)
    assert rec["failed"] == rec["attempted"] >= 1
