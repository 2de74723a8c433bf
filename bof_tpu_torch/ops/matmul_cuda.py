"""Kernel K1: the superblock accumulate step `C += alpha * op(A) op(B)`.

`accum_matmul` launches a hand-written CUDA kernel (replacing
`bof_tpu/ops/matmul_pallas.py:matmul` plus `bof_tpu/ops/device.py:
accum_step`'s epilogue) on CUDA tensors, and runs its plain PyTorch
version, `accum_matmul_ref`, on CPU tensors.  Nothing else chooses between
the two: a CUDA tensor launches the kernel or raises.

K1 has five variants, and `k1_variant` alone picks one.  On fp32 operands
of any layout, leading dimension and base address:
- 'tf32x3' (`csrc/matmul_tf32.cu`, 3 passes): TMA + wgmma 3xTF32, for
  precision 'highest' and 'high';
- 'tf32' (the same kernel, 1 pass): one TF32 pass, for 'default'.
Their split pass first writes a K-major copy of each operand `k1_packs`
names (MN-major, or where TMA cannot read it), counted in
`accum_matmul.tf32_packs`, and the lo parts for 3 passes (`k1_workspace`).
On the transfer modes' operands (FlashConfig.transfer_dtype), C fp32:
- 'bf16' (`csrc/matmul_lowp.cu`): bf16 A and B, TMA + wgmma with an fp32
  accumulator, at every precision (bof_tpu's bf16 tiles);
- 's8' (the same kernel body): int8 A and B summed exactly in int32, then
  C += alpha * float(sum) in two roundings (bof_tpu's `accum_step_q`,
  alpha = its scale); K at most `K1_S8_MAX_K`.
- 's8_i32' (the same kernel body, an int32 C): C += the exact int32 sum
  of the int8 products, no rescale (alpha must be 1), for the sharded
  step whose partials are summed across cards before the one rescale
  (bof_tpu's `parallel/mesh.py:sharded_accum_step_q`); K at most
  `K1_S8_MAX_K`, exact while the result fits in int32.
All three read K-major operands only: a pack pass in the same file first
writes a K-major copy of each operand `k1_packs` names, counted in
`accum_matmul.lowp_packs`.
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
K1_VARIANTS = ("tf32x3", "tf32", "bf16", "s8", "s8_i32", "f64")
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


def k1_variant(prec: str, *, dtype: torch.dtype = torch.float32,
               c_dtype: torch.dtype = torch.float32) -> str:
    """The K1 variant a CUDA launch runs.  float64 operands (`dtype`) run
    'f64', bf16 operands 'bf16' and int8 operands 's8' ('s8_i32' into an
    int32 C, `c_dtype`); fp32 operands run
    'tf32x3' for 'highest'/'high' and 'tf32' for 'default'.  No layout,
    leading dimension or base address changes the choice: each variant's
    pass before the product writes a K-major copy of an operand TMA
    cannot read where it lies (`k1_packs`), and C has no constraint (the
    epilogue stores floats one by one).  Raises ValueError on an unknown
    `prec`."""
    passes = _passes(prec)
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.int8 and c_dtype == torch.int32:
        return "s8_i32"
    if dtype in _LOWP:
        return _LOWP[dtype][0]
    return "tf32x3" if passes == 3 else "tf32"


def k1_workspace(m: int, n: int, k: int, *, a_km: bool, b_nk: bool,
                 passes: int, lda: int, ldb: int, aligned: tuple) -> dict:
    """Row counts of the K-major fp32 workspaces the fp32 variants write
    before the product (each rows x `tf32_ldw(k)`): 'a_x' (op(A) rewritten
    K-major) and 'b_x' (op(B)^T) for each operand `k1_packs` names (stored
    MN-major: a_km, or B stored (K,N); or K-major where TMA cannot read it:
    a storage leading dimension `lda`/`ldb` that is not a multiple of 4
    floats, or a base that is not 16-byte `aligned`, for A and B), and
    'a_lo'/'b_lo' (x - tf32(x)) for 3 passes."""
    pack_a, pack_b = k1_packs(a_km, b_nk, lda, ldb, torch.float32, aligned)
    rows = {}
    if pack_a:
        rows["a_x"] = m
    if pack_b:
        rows["b_x"] = n
    if passes == 3:
        rows["a_lo"] = m
        rows["b_lo"] = n
    return rows


def k1_ldw(k: int, itemsize: int = 4) -> int:
    """Leading dimension of the 'bf16' and 's8' pack pass's workspaces, in
    elements of `itemsize` bytes: k rounded up to 16 bytes (8 bf16, 16
    int8; 4 floats).  The fp32 split pass's rows are `tf32_ldw`'s."""
    step = 16 // itemsize
    return -(-k // step) * step


def tf32_ldw(k: int) -> int:
    """Leading dimension of the fp32 split pass's workspaces (K1's fp32
    variants, B7's assign): k rounded up to 32 floats, so that every row
    starts a 128-byte line.  TMA needs only 16 bytes, but on the H100 rows
    16 bytes off a line made K1 at 8192 x 8193 x 8193 (ld 8196) 1.8x
    slower than at 8192^3 (PERF.md)."""
    return -(-k // 32) * 32


def k1_packs(a_km: bool, b_nk: bool, lda: int, ldb: int,
             dtype: torch.dtype, aligned: tuple = (True, True)) -> tuple:
    """Which operands, (A, B), K1's pass before the product rewrites
    K-major: the fp32 variants' split pass (into a workspace of
    `tf32_ldw(k)` columns) and the 'bf16' and 's8' variants' pack pass
    (`k1_ldw(k, itemsize)` columns) alike.  One whose storage is not
    K-major (a_km, or B stored (K,N)), or that TMA cannot read where it
    lies: its storage leading dimension (lda, ldb elements of `dtype`) not
    a multiple of 16 bytes, or its base not 16-byte aligned (`aligned`,
    for A and B)."""
    a_ok, b_ok = aligned
    size = dtype.itemsize
    return (bool(a_km or not a_ok or lda * size % 16),
            bool(not b_nk or not b_ok or ldb * size % 16))


def fp32_workspace(rows: dict, ld: int, device) -> tuple:
    """One fp32 device buffer cut into the named blocks of `rows[name]`
    rows of `ld` floats each (ld a multiple of 4, so every block starts
    16-byte aligned): (the buffer, name -> address).  The caller keeps the
    buffer until its launch is enqueued."""
    ws = torch.empty(sum(rows.values()) * ld, dtype=torch.float32,
                     device=device)
    ptr, off = {}, 0
    for name, r in rows.items():
        ptr[name] = ws.data_ptr() + 4 * off
        off += r * ld
    return ws, ptr


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


def s8_product_ref(a: torch.Tensor, b: torch.Tensor, *, a_km: bool,
                   b_nk: bool) -> torch.Tensor:
    """The exact integer product op(a) @ op(b) of int8 operands, as int64
    (logical (M, N)): summed in float64, whose 53 bits hold any such sum up
    to K1_S8_MAX_K."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return ((a.T if a_km else a) @ (b.T if b_nk else b)).to(torch.int64)


def accum_matmul_s8_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        scale: float, *, a_km: bool, b_nk: bool,
                        c_nm: bool) -> torch.Tensor:
    """Plain version of the 's8' variants, bit for bit.  fp32 c: the exact
    product (`s8_product_ref`) to fp32, then c += (that * scale), the
    multiply and the add each rounded in fp32 (bof_tpu's accum_step_q).
    int32 c ('s8_i32'): c += the exact product in int32 (`scale` must be
    1)."""
    _logical_dims(c, a, b, a_km, b_nk, c_nm)
    out = s8_product_ref(a, b, a_km=a_km, b_nk=b_nk)
    if c.dtype == torch.int32:
        if scale != 1:
            raise ValueError("the int32 output takes no scale (alpha 1)")
        out = out.to(torch.int32)
    else:
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
    most K1_S8_MAX_K); int32 c with int8 a and b and alpha 1 (the exact
    sum, 's8_i32'); or all three float64.  Contiguous, one device.  CUDA
    tensors launch the K1 variant `k1_variant` names on the current stream;
    CPU tensors take the plain version, full fp32 (or fp64) at every
    `prec`."""
    m, n, k = _logical_dims(c, a, b, a_km, b_nk, c_nm)
    passes = _passes(prec)
    devs = {c.device, a.device, b.device}
    if len(devs) != 1:
        raise ValueError(f"accum_matmul operands on several devices: {devs}")
    f64 = c.dtype == a.dtype == b.dtype == torch.float64
    i32 = c.dtype == torch.int32 and a.dtype == b.dtype == torch.int8
    if not (f64 or i32) and (c.dtype != torch.float32 or a.dtype != b.dtype
                             or a.dtype not in (torch.float32, torch.bfloat16,
                                                torch.int8)):
        raise TypeError(f"accum_matmul takes fp32 C and fp32, bf16 or int8 "
                        f"A and B of one type, int32 C and int8 A and B, or "
                        f"float64 C, A and B (c {c.dtype}, a {a.dtype}, b "
                        f"{b.dtype})")
    if i32 and alpha != 1:
        raise ValueError("accum_matmul into int32 C takes alpha 1 (the "
                         "exact sum; rescale after)")
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
    variant = k1_variant(prec, dtype=a.dtype, c_dtype=c.dtype)
    lib = build()
    packs, tf32_packs = (False, False), 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if a.dtype in _LOWP:
            packs = k1_packs(a_km, b_nk, lda, ldb, a.dtype, aligned)
            ldw = k1_ldw(k, a.element_size())
            ws = [torch.empty((rows, ldw), dtype=a.dtype, device=dev)
                  if pack else None for pack, rows in zip(packs, (m, n))]
            ws_ptrs = [None if w is None else w.data_ptr() for w in ws]
            if i32:
                entry = "bof_accum_matmul_s8_i32"
                rc = lib.bof_accum_matmul_s8_i32(
                    c.data_ptr(), a.data_ptr(), b.data_ptr(), m, n, k,
                    int(a_km), int(b_nk), int(c_nm), lda, ldb, c.shape[1],
                    *ws_ptrs, ldw, stream)
            else:
                entry = "bof_accum_matmul_lowp"
                rc = lib.bof_accum_matmul_lowp(
                    c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha),
                    m, n, k, int(a_km), int(b_nk), int(c_nm), lda, ldb,
                    c.shape[1], _LOWP[a.dtype][1], *ws_ptrs, ldw, stream)
        elif variant == "f64":
            entry = "bof_accum_matmul_f64"
            rc = lib.bof_accum_matmul_f64(
                c.data_ptr(), a.data_ptr(), b.data_ptr(), float(alpha), m, n,
                k, int(a_km), int(b_nk), int(c_nm), lda, ldb, c.shape[1],
                stream)
        else:
            entry = "bof_accum_matmul_tf32"
            rows = k1_workspace(m, n, k, a_km=a_km, b_nk=b_nk, passes=passes,
                                lda=lda, ldb=ldb, aligned=aligned)
            tf32_packs = ("a_x" in rows) + ("b_x" in rows)
            ldw = tf32_ldw(k)
            ws, ptr = fp32_workspace(rows, ldw, dev)
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
    accum_matmul.tf32_packs += tf32_packs
    return c


def reset_launch_counts() -> None:
    """Set K1's launch count, its per-variant counts and the counts of
    operands the low-precision pack pass (`lowp_packs`) and the fp32
    split pass (`tf32_packs`) rewrote K-major to 0."""
    accum_matmul.launches = 0
    accum_matmul.variant_launches = dict.fromkeys(K1_VARIANTS, 0)
    accum_matmul.lowp_packs = 0
    accum_matmul.tf32_packs = 0


reset_launch_counts()
