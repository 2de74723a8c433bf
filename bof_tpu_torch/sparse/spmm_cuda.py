"""Kernel K2 (ELL SpMM) and the ELL SpMV, on torch.

The counterpart of `bof_tpu/sparse/spmm_pallas.py`.  `spmm_ell` launches
the hand-written CUDA kernel `bof_spmm_ell` (`csrc/spmm_ell.cu`,
replacing `spmm_pallas.py:spmm_ell_pallas` and its XLA twin
`spmm_device.py:ell_gather_reduce`); `spmv_ell` launches
`bof_spmv_ell` (replacing the XLA step `spmm_device.py:
spmv_ell_block`).  On CPU tensors each runs its plain PyTorch version
(`spmm_ell_ref`, `spmv_ell_ref`); on a CUDA tensor it launches the kernel
or raises.  Each wrapper counts its launches in `.launches`, and by value
type ('f32', 'bf16', 's8') in `.variant_launches`.

The contract, in the wrappers, the plain versions and the kernels alike:
with n ELL rows (n = len(rows) when `rows` is given, else all of ja's)

    out[rows[i]] = alpha * sum_{s < counts[i]} v(i, s) * dense[ja[i, s]]

where v = va for fp32 values, v = float(va) (exact) for bf16, and
v = float(va) * va_scale[i] (one fp32 rounding) for int8 values with one
fp32 scale an ELL row (`va_scale`, indexed by i, not by rows[i]): bof_tpu's
`promote_ell_vals` for its transfer modes (FlashConfig.transfer_dtype).

`counts` (int32, n entries; None: every slot is real) stops each row's
slot loop, so padding slots are never read; `rows` (int32, n entries)
says where ELL row i lands in `out`, and every row of `out` it does not
name keeps what it held.  Without `rows` and `out` the call returns a new
(n, cb) tensor (n for the SpMV).  The sum is fp32, then times alpha once.
csrmm and csrgemv use it to let each band write its rows of a row-block
buffer in place.

The Pallas kernel's eligibility gates (`pallas_feasible`,
`pallas_eligible`) exist only for the v5e's VMEM and are not ported: the
CUDA kernel takes any panel height and any rmax, and K2 a cb of up to
65535 slabs of 64 columns.
"""
from __future__ import annotations

import torch

from ..ops.cuda_lib import build

_IDX_TYPES = (torch.int32, torch.uint16)
# va dtype -> (kernel va_kind, variant name)
_VAL_KINDS = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
              torch.int8: (2, "s8")}
ELL_VARIANTS = tuple(v for _, v in _VAL_KINDS.values())


def _check(name, dense, ja_ell, va_ell, dense_dim, va_scale):
    if ja_ell.dim() != 2 or va_ell.shape != ja_ell.shape:
        raise ValueError(f"{name}: ja {tuple(ja_ell.shape)} and va "
                         f"{tuple(va_ell.shape)} must be one (rows, rmax) "
                         "shape")
    if dense.dim() != dense_dim:
        raise ValueError(f"{name}: dense operand must be {dense_dim}-D, got "
                         f"{tuple(dense.shape)}")
    if dense.dtype != torch.float32 or va_ell.dtype not in _VAL_KINDS:
        raise TypeError(f"{name} takes an fp32 dense operand and fp32, bf16 "
                        f"or int8 values (dense {dense.dtype}, va "
                        f"{va_ell.dtype})")
    if (va_scale is not None) != (va_ell.dtype == torch.int8):
        raise ValueError(f"{name}: va_scale goes with int8 values, and only "
                         "with them")
    if va_scale is not None and (
            va_scale.dtype != torch.float32
            or tuple(va_scale.shape) != (ja_ell.shape[0],)
            or va_scale.device != dense.device
            or not va_scale.is_contiguous()):
        raise ValueError(f"{name}: va_scale must be contiguous fp32, one "
                         f"entry per ELL row ({ja_ell.shape[0]}) on "
                         f"{dense.device}")
    if ja_ell.dtype not in _IDX_TYPES:
        raise TypeError(f"{name}: ja must be int32 or uint16, got "
                        f"{ja_ell.dtype}")
    devs = {dense.device, ja_ell.device, va_ell.device}
    if len(devs) != 1:
        raise ValueError(f"{name} operands on several devices: {devs}")
    if not (dense.is_contiguous() and ja_ell.is_contiguous()
            and va_ell.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    dev = dense.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if ja_ell.shape[0] > 2 ** 31 - 1:
        raise ValueError(f"{name}: {ja_ell.shape[0]} rows exceed one grid")
    return dev


def _check_placement(name, dev, ja_ell, counts, rows, out, width):
    """n, the ELL rows computed, after checking counts, rows and out
    against the contract; `width` is out's shape past its rows."""
    n = ja_ell.shape[0] if rows is None else rows.shape[0]
    for t, what in ((counts, "counts"), (rows, "rows")):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name}: {what} must be 1-D int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on {dev}")
    if n > ja_ell.shape[0]:
        raise ValueError(f"{name}: {n} rows named, the ELL has "
                         f"{ja_ell.shape[0]}")
    if counts is not None and counts.shape[0] != n:
        raise ValueError(f"{name}: counts has {counts.shape[0]} entries, "
                         f"not one per ELL row ({n})")
    if out is None:
        if rows is not None:
            raise ValueError(f"{name}: rows needs an out tensor to land in")
        return n
    if out.dtype != torch.float32 or out.device != dev \
            or not out.is_contiguous():
        raise ValueError(f"{name}: out must be contiguous fp32 on {dev}")
    if tuple(out.shape[1:]) != width or (rows is None and out.shape[0] != n):
        raise ValueError(f"{name}: out {tuple(out.shape)} does not take "
                         f"{n} rows of shape {width}")
    return n


def promote_vals(va_ell, va_scale=None):
    """v(i, s) of the contract as fp32: bf16 exactly, int8 times its row's
    scale (one fp32 rounding, as bof_tpu's promote_ell_vals)."""
    if va_scale is not None:
        return va_ell.to(torch.float32) * va_scale[:, None]
    return va_ell.to(torch.float32)


def _ell_ref(gather, dense, ja_ell, va_ell, counts, rows, out, alpha,
             va_scale):
    """The plain version of both kernels: `gather(dense, idx)` reads the
    dense operand at the ELL indices; slots past counts are masked before
    the gather (their ja may hold anything) and after the product."""
    n = ja_ell.shape[0] if rows is None else rows.shape[0]
    ja = ja_ell[:n].to(torch.int64)
    va = promote_vals(va_ell[:n],
                      None if va_scale is None else va_scale[:n])
    keep = None
    if counts is not None:
        keep = (torch.arange(ja.shape[1], device=ja.device)[None, :]
                < counts.to(torch.int64)[:, None])
        ja = torch.where(keep, ja, 0)
    prod = gather(dense, ja, va)
    if keep is not None:
        prod = torch.where(keep.view(keep.shape + (1,) * (prod.dim() - 2)),
                           prod, 0.0)
    res = prod.sum(1) * alpha
    if out is None:
        return res
    if rows is None:
        out.copy_(res)
    else:
        out.index_copy_(0, rows.to(torch.int64), res)
    return out


def spmm_ell_ref(b_panel: torch.Tensor, ja_ell: torch.Tensor,
                 va_ell: torch.Tensor, *, counts=None, rows=None, out=None,
                 alpha: float = 1.0, va_scale=None) -> torch.Tensor:
    """Plain PyTorch version of K2 under the module's contract (the values
    promoted to fp32 first; the gather materializes n * rmax * cb
    values)."""
    return _ell_ref(lambda b, ja, va: va[:, :, None] * b[ja], b_panel,
                    ja_ell, va_ell, counts, rows, out, alpha, va_scale)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(fn, dev, *args):
    """fn(*args, stream) on `dev`'s current stream; raises on a non-zero
    CUDA error code."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def spmm_ell(b_panel: torch.Tensor, ja_ell: torch.Tensor,
             va_ell: torch.Tensor, *, counts=None, rows=None, out=None,
             alpha: float = 1.0, va_scale=None) -> torch.Tensor:
    """out[rows[i], :] = alpha * sum_{s < counts[i]} v(i, s) *
    b_panel[ja_ell[i, s], :] (the module's contract).

    b_panel: (k, cb) fp32; ja_ell: (rows, rmax) int32 or uint16 with real
    entries in [0, k); va_ell: (rows, rmax) fp32, bf16, or int8 with
    `va_scale` (rows,) fp32.  Any rmax, and cb up to 65535 * 64 (a wider
    cb fails to launch).
    Returns `out`, or a new (rows, cb) fp32 tensor; CUDA tensors launch K2
    on the current stream, CPU tensors take the plain version."""
    dev = _check("spmm_ell", b_panel, ja_ell, va_ell, 2, va_scale)
    cb = b_panel.shape[1]
    n = _check_placement("spmm_ell", dev, ja_ell, counts, rows, out, (cb,))
    if dev.type == "cpu":
        return spmm_ell_ref(b_panel, ja_ell, va_ell, counts=counts,
                            rows=rows, out=out, alpha=alpha,
                            va_scale=va_scale)
    if out is None:
        out = torch.empty((n, cb), dtype=torch.float32, device=dev)
    vec4 = (cb % 4 == 0 and b_panel.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    kind, variant = _VAL_KINDS[va_ell.dtype]
    _launch(build().bof_spmm_ell, dev, out.data_ptr(),
            b_panel.data_ptr(), ja_ell.data_ptr(),
            int(ja_ell.dtype == torch.uint16), va_ell.data_ptr(), kind,
            _ptr(va_scale), _ptr(counts), _ptr(rows), float(alpha), n,
            ja_ell.shape[1], cb, int(vec4))
    spmm_ell.launches += 1
    spmm_ell.variant_launches[variant] += 1
    return out


def spmv_ell_ref(x: torch.Tensor, ja_ell: torch.Tensor,
                 va_ell: torch.Tensor, *, counts=None, rows=None, out=None,
                 alpha: float = 1.0, va_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the SpMV under the module's contract."""
    return _ell_ref(lambda xv, ja, va: va * xv[ja], x, ja_ell, va_ell,
                    counts, rows, out, alpha, va_scale)


def spmv_ell(x: torch.Tensor, ja_ell: torch.Tensor,
             va_ell: torch.Tensor, *, counts=None, rows=None, out=None,
             alpha: float = 1.0, va_scale=None) -> torch.Tensor:
    """y[rows[i]] = alpha * sum_{s < counts[i]} v(i, s) * x[ja_ell[i, s]]
    (csrgemv 'N'; the module's contract).

    x: (k,) fp32; ja_ell/va_ell/va_scale as for `spmm_ell`.  Returns
    `out`, or a new (rows,) fp32 tensor; CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    dev = _check("spmv_ell", x, ja_ell, va_ell, 1, va_scale)
    n = _check_placement("spmv_ell", dev, ja_ell, counts, rows, out, ())
    if dev.type == "cpu":
        return spmv_ell_ref(x, ja_ell, va_ell, counts=counts, rows=rows,
                            out=out, alpha=alpha, va_scale=va_scale)
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=dev)
    rmax = ja_ell.shape[1]
    vec = (rmax % 4 == 0
           and va_ell.data_ptr() % (4 * va_ell.element_size()) == 0
           and ja_ell.data_ptr() % (4 * ja_ell.element_size()) == 0)
    kind, variant = _VAL_KINDS[va_ell.dtype]
    _launch(build().bof_spmv_ell, dev, out.data_ptr(), x.data_ptr(),
            ja_ell.data_ptr(), int(ja_ell.dtype == torch.uint16),
            va_ell.data_ptr(), kind, _ptr(va_scale), _ptr(counts),
            _ptr(rows), float(alpha), n, rmax, int(vec))
    spmv_ell.launches += 1
    spmv_ell.variant_launches[variant] += 1
    return out


def reset_launch_counts() -> None:
    """Set both kernels' launch counts and their per-variant counts to 0."""
    for fn in (spmm_ell, spmv_ell):
        fn.launches = 0
        fn.variant_launches = dict.fromkeys(ELL_VARIANTS, 0)


reset_launch_counts()
