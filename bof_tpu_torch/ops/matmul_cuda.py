"""Kernel K1: the superblock accumulate step `C += alpha * op(A) op(B)`.

`accum_matmul` launches a hand-written CUDA kernel (replacing
`bof_tpu/ops/matmul_pallas.py:matmul` plus `bof_tpu/ops/device.py:
accum_step`'s epilogue) on CUDA tensors, and runs its plain PyTorch
version, `accum_matmul_ref`, on CPU tensors.  Nothing else chooses between
the two: a CUDA tensor launches the kernel or raises.

K1 has five variants, and `k1_variant` alone picks one.  On fp32 operands:
- 'tf32x3' (`csrc/matmul_tf32.cu`, 3 passes): TMA + wgmma 3xTF32, for
  precision 'highest' and 'high';
- 'tf32' (the same kernel, 1 pass): one TF32 pass, for 'default';
- 'ffma' (`csrc/matmul.cu`): full fp32 FFMA, for operands TMA cannot
  describe (a leading dimension that is not a multiple of 4 floats, or a
  base address that is not 16-byte aligned), at every precision.
On the transfer modes' operands (FlashConfig.transfer_dtype), C fp32:
- 'bf16' (`csrc/matmul_lowp.cu`): bf16 A and B, TMA + wgmma with an fp32
  accumulator, at every precision (bof_tpu's bf16 tiles);
- 's8' (the same kernel body): int8 A and B summed exactly in int32, then
  C += alpha * float(sum) in two roundings (bof_tpu's `accum_step_q`,
  alpha = its scale); K at most `K1_S8_MAX_K`.
Both read K-major operands only: a pack pass in the same file first
writes a K-major copy of each operand `lowp_packs` names.
On float64 C, A and B (bof_tpu's FP_DOUBLE_PRECISION gemm):
- 'f64' (`csrc/matmul_f64.cu`): DMMA on the fp64 tensor cores, every
  layout and leading dimension, at every precision (bof_tpu's Ozaki
  emulation, `ops/gemm64.py:_slice_accum`, exists only because a TPU has
  no fp64 unit).

The kernels are built at first use with the port's other kernels into one
library (`ops/cuda_lib.py`).
"""
from __future__ import annotations

import torch

from .cuda_lib import build

# matmul precision -> tensor-core passes; each tier keeps at least the bits
# the TPU's tier keeps ('highest': 6 bf16 passes; 'default': 1 bf16 pass)
K1_PASSES = {"highest": 3, "high": 3, "default": 1}
K1_VARIANTS = ("tf32x3", "tf32", "ffma", "bf16", "s8", "f64")
# the int32 sum of K int8 products is exact while 127^2 * K < 2^31
K1_S8_MAX_K = 1 << 17
_LOWP = {torch.bfloat16: ("bf16", 0), torch.int8: ("s8", 1)}


def _logical_dims(c, a, b, a_km, b_nk, c_nm):
    if a.dim() != 2 or b.dim() != 2 or c.dim() != 2:
        raise ValueError("accum_matmul takes 2-D tensors")
    m, k = (a.shape[1], a.shape[0]) if a_km else a.shape
    k2, n = (b.shape[1], b.shape[0]) if b_nk else b.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: a {tuple(a.shape)} "
                         f"(a_km={a_km}) vs b {tuple(b.shape)} (b_nk={b_nk})")
    want_c = (n, m) if c_nm else (m, n)
    if tuple(c.shape) != want_c:
        raise ValueError(f"c is {tuple(c.shape)}, expected {want_c} "
                         f"(c_nm={c_nm})")
    return m, n, k


def _passes(prec: str) -> int:
    if prec not in K1_PASSES:
        raise ValueError(f"unknown matmul precision {prec!r} (one of "
                         f"{sorted(K1_PASSES)})")
    return K1_PASSES[prec]


def k1_variant(lda: int, ldb: int, prec: str, *, aligned: bool = True,
               dtype: torch.dtype = torch.float32) -> str:
    """The K1 variant a CUDA launch runs.  float64 operands (`dtype`) run
    'f64', bf16 operands 'bf16' and int8 operands 's8', whatever their
    layout (the low-precision pack pass makes a K-major copy where TMA
    cannot read one, `lowp_packs`).  fp32
    operands run 'tf32x3' for 'highest'/'high', 'tf32' for 'default',
    when TMA can describe both (storage leading
    dimensions `lda`, `ldb` multiples of 4 floats, i.e. 16 bytes, and both
    base addresses 16-byte `aligned`); 'ffma', the full-fp32 FFMA kernel,
    otherwise.  C has no constraint (the epilogue stores floats one by
    one).  Raises ValueError on an unknown `prec`."""
    passes = _passes(prec)
    if dtype == torch.float64:
        return "f64"
    if dtype in _LOWP:
        return _LOWP[dtype][0]
    if not aligned or lda % 4 or ldb % 4:
        return "ffma"
    return "tf32x3" if passes == 3 else "tf32"


def k1_workspace(m: int, n: int, k: int, *, a_km: bool, b_nk: bool,
                 passes: int) -> dict:
    """Row counts of the K-major fp32 workspaces the tensor-core variants
    write before the product (each rows x `k1_ldw(k)`): 'a_x' (op(A)
    rewritten K-major) when a_km, 'b_x' (op(B)^T) when B is stored (K,N),
    and 'a_lo'/'b_lo' (x - tf32(x)) for 3 passes."""
    rows = {}
    if a_km:
        rows["a_x"] = m
    if not b_nk:
        rows["b_x"] = n
    if passes == 3:
        rows["a_lo"] = m
        rows["b_lo"] = n
    return rows


def k1_ldw(k: int, itemsize: int = 4) -> int:
    """Leading dimension of the workspaces, in elements of `itemsize`
    bytes: k rounded up to 16 bytes (4 floats, 8 bf16, 16 int8)."""
    step = 16 // itemsize
    return -(-k // step) * step


def lowp_packs(a_km: bool, b_nk: bool, lda: int, ldb: int,
               dtype: torch.dtype, aligned: tuple = (True, True)) -> tuple:
    """Which operands, (A, B), the 'bf16' and 's8' variants' pack pass
    rewrites K-major (into a workspace of `k1_ldw(k, itemsize)` columns)
    before the product: one whose storage is not K-major (a_km, or B
    stored (K,N)), or that TMA cannot read where it lies: its storage
    leading dimension (lda, ldb elements of `dtype`) not a multiple of 16
    bytes, or its base not 16-byte aligned (`aligned`, for A and B)."""
    a_ok, b_ok = aligned
    size = dtype.itemsize
    return (bool(a_km or not a_ok or lda * size % 16),
            bool(not b_nk or not b_ok or ldb * size % 16))


def pack_kmajor_ref(x: torch.Tensor, *, mn_major: bool,
                    ld: int) -> torch.Tensor:
    """Plain version of the low-precision variants' pack pass: the K-major
    copy of a stored operand (`x` (rows, K), or (K, rows) when `mn_major`)
    as a (rows, ld) tensor, ld >= K, whose columns past K are zero (the
    kernel's workspace leaves them unwritten and never reads them).  For
    tests and chip_smoke.py only: the CPU path needs no packing."""
    src = x.T if mn_major else x
    rows, k = src.shape
    if ld < k:
        raise ValueError(f"pack_kmajor_ref: ld {ld} < K {k}")
    out = x.new_zeros((rows, ld))
    out[:, :k] = src
    return out


def accum_matmul_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     alpha: float, *, a_km: bool, b_nk: bool,
                     c_nm: bool) -> torch.Tensor:
    """Plain PyTorch version of K1 at every precision: c += alpha *
    op(a) @ op(b) in c's storage layout, in place; returns c.  float64
    stays float64 throughout; bf16 operands are promoted to fp32 first
    (their products are exact there); int8 operands take
    `accum_matmul_s8_ref`."""
    _logical_dims(c, a, b, a_km, b_nk, c_nm)
    if a.dtype == torch.int8:
        return accum_matmul_s8_ref(c, a, b, alpha, a_km=a_km, b_nk=b_nk,
                                   c_nm=c_nm)
    a, b = a.to(c.dtype), b.to(c.dtype)
    out = (a.T if a_km else a) @ (b.T if b_nk else b)
    return c.add_(out.T if c_nm else out, alpha=float(alpha))


def accum_matmul_s8_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        scale: float, *, a_km: bool, b_nk: bool,
                        c_nm: bool) -> torch.Tensor:
    """Plain version of the 's8' variant, bit for bit: the int8 product
    summed exactly (in float64, whose 53 bits hold any such sum up to
    K1_S8_MAX_K), to int64, to fp32, then c += (that * scale), the multiply
    and the add each rounded in fp32 (bof_tpu's accum_step_q)."""
    _logical_dims(c, a, b, a_km, b_nk, c_nm)
    a, b = a.to(torch.float64), b.to(torch.float64)
    out = ((a.T if a_km else a) @ (b.T if b_nk else b)).to(torch.int64)
    out = out.to(torch.float32) * float(scale)
    return c.add_(out.T if c_nm else out)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 x with its 13 low mantissa bits cleared: TF32 by truncation."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def accum_matmul_tf32_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          alpha: float, *, a_km: bool, b_nk: bool,
                          c_nm: bool) -> torch.Tensor:
    """Plain one-pass TF32 emulation: `accum_matmul_ref` on operands
    truncated to TF32, the 'tf32' variant's arithmetic up to summation
    order.  For tests and chip_smoke.py only."""
    return accum_matmul_ref(c, tf32_truncate(a), tf32_truncate(b), alpha,
                            a_km=a_km, b_nk=b_nk, c_nm=c_nm)


def accum_matmul(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 alpha: float, *, a_km: bool, b_nk: bool,
                 c_nm: bool, prec: str = "highest") -> torch.Tensor:
    """c += alpha * op(a) @ op(b), in place, all in storage-major layout:
    a is (M,K) or (K,M) with a_km; b is (K,N) or (N,K) with b_nk; c is
    (M,N) or (N,M) with c_nm.  c fp32 with a and b both fp32, both bf16 or
    both int8 (then alpha is bof_tpu's scale alpha * s_a * s_b and K at
    most K1_S8_MAX_K); or all three float64.  Contiguous, one device.  CUDA
    tensors launch the K1 variant `k1_variant` names on the current stream;
    CPU tensors take the plain version, full fp32 (or fp64) at every
    `prec`."""
    m, n, k = _logical_dims(c, a, b, a_km, b_nk, c_nm)
    passes = _passes(prec)
    devs = {c.device, a.device, b.device}
    if len(devs) != 1:
        raise ValueError(f"accum_matmul operands on several devices: {devs}")
    f64 = c.dtype == a.dtype == b.dtype == torch.float64
    if not f64 and (c.dtype != torch.float32 or a.dtype != b.dtype
                    or a.dtype not in (torch.float32, torch.bfloat16,
                                       torch.int8)):
        raise TypeError(f"accum_matmul takes fp32 C and fp32, bf16 or int8 "
                        f"A and B of one type, or float64 C, A and B (c "
                        f"{c.dtype}, a {a.dtype}, b {b.dtype})")
    if a.dtype == torch.int8 and k > K1_S8_MAX_K:
        raise ValueError(f"int8 accum_matmul with k={k} > {K1_S8_MAX_K}: "
                         "the int32 sum could overflow")
    if not (c.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("accum_matmul needs contiguous tensors")
    dev = c.device
    if dev.type == "cpu":
        return accum_matmul_ref(c, a, b, alpha, a_km=a_km, b_nk=b_nk,
                                c_nm=c_nm)
    if dev.type != "cuda":
        raise ValueError(f"accum_matmul: unsupported device {dev}")
    if min(m, n, k) == 0:
        return c  # nothing to add; the C entries would launch nothing
    lda, ldb = a.shape[1], b.shape[1]
    aligned = (a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
    variant = k1_variant(lda, ldb, prec, aligned=all(aligned), dtype=a.dtype)
    lib = build()
    packs = (False, False)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if a.dtype in _LOWP:
            entry = "bof_accum_matmul_lowp"
            packs = lowp_packs(a_km, b_nk, lda, ldb, a.dtype, aligned)
            ldw = k1_ldw(k, a.element_size())
            ws = [torch.empty((rows, ldw), dtype=a.dtype, device=dev)
                  if pack else None for pack, rows in zip(packs, (m, n))]
            rc = lib.bof_accum_matmul_lowp(
                c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha), m, n,
                k, int(a_km), int(b_nk), int(c_nm), lda, ldb, c.shape[1],
                _LOWP[a.dtype][1], *(None if w is None else w.data_ptr()
                                     for w in ws), ldw, stream)
        elif variant == "f64":
            entry = "bof_accum_matmul_f64"
            rc = lib.bof_accum_matmul_f64(
                c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha), m, n,
                k, int(a_km), int(b_nk), int(c_nm), lda, ldb, c.shape[1],
                stream)
        elif variant == "ffma":
            entry = "bof_accum_matmul_f32"
            rc = lib.bof_accum_matmul_f32(
                c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha), m, n,
                k, int(a_km), int(b_nk), int(c_nm), lda, ldb, c.shape[1],
                stream)
        else:
            entry = "bof_accum_matmul_tf32"
            rows = k1_workspace(m, n, k, a_km=a_km, b_nk=b_nk, passes=passes)
            ldw = k1_ldw(k)
            ws = torch.empty(sum(rows.values()) * ldw, dtype=torch.float32,
                             device=dev)
            ptr, off = {}, 0
            for name, r in rows.items():
                ptr[name] = ws.data_ptr() + 4 * off
                off += r * ldw
            rc = lib.bof_accum_matmul_tf32(
                c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha), m, n,
                k, int(a_km), int(b_nk), int(c_nm), lda, ldb, c.shape[1],
                passes, ptr.get("a_x"), ptr.get("a_lo"), ptr.get("b_x"),
                ptr.get("b_lo"), ldw, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    accum_matmul.launches += 1
    accum_matmul.variant_launches[variant] += 1
    accum_matmul.lowp_packs += sum(packs)
    return c


def reset_launch_counts() -> None:
    """Set K1's launch count, its per-variant counts and the count of
    operands the low-precision pack pass rewrote (`lowp_packs`) to 0."""
    accum_matmul.launches = 0
    accum_matmul.variant_launches = dict.fromkeys(K1_VARIANTS, 0)
    accum_matmul.lowp_packs = 0


reset_launch_counts()
