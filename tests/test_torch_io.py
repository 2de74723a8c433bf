"""The port's storage layer (`bof_tpu_torch/io/{stride,store,pystore,
native}.py`, the engine built from bof_tpu_torch/native/) against bof_tpu's,
case for case after tests/test_io.py: the same seeded randomized trials of
reads, strided reads, writes, strided writes and store-to-store copies run
through both packages' stores of one backend, and each read must be the
same bytes in both and the file's arithmetic pattern (or its shadow copy),
on every backend: MemStore, PyFileStore, NativeFileStore buffered and
O_DIRECT (with kernel AIO and span-coalesced reads)."""
import ctypes

import numpy as np
import pytest

from torch_pair import BOTH, engine, run_both

FILE_ELEMS = 1 << 18  # 256K uint32 = 1 MiB
BACKENDS = ["mem", "py", "native", "native_direct"]


def iota_file(n=FILE_ELEMS):
    return np.arange(n, dtype=np.uint32)


def contiguous(pk, nbytes):
    return pk.mod("io.stride").StrideInfo.contiguous(nbytes)


def strided(pk, stride, n_strides, len_per_stride):
    return pk.mod("io.stride").StrideInfo(
        stride=stride, n_strides=n_strides, len_per_stride=len_per_stride)


def make_store(pk, kind, tmp_path, data):
    """One store of `kind` over `data`'s bytes, in a directory of the
    package's own; the native kinds need the package's engine."""
    raw = data.view(np.uint8).ravel()
    if kind == "mem":
        st = pk.mod("io.store").MemStore(raw.nbytes)
        st.write(0, contiguous(pk, raw.nbytes), raw).wait()
        return st
    d = tmp_path / pk.name
    d.mkdir(exist_ok=True)
    path = str(d / f"io_{kind}.bin")
    with open(path, "wb") as f:
        f.write(raw.tobytes())
    if kind == "py":
        pystore = pk.mod("io.pystore")
        return pystore.PyFileStore(path, pystore.PyIoPool(4))
    engine(pk)
    return pk.mod("io.native").NativeFileStore(
        path, o_direct=(kind == "native_direct"), n_threads=4)


def assert_same(ref, port):
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("kind", BACKENDS)
def test_contiguous_read_randomized(kind, tmp_path):
    def trials(pk):
        rng = np.random.default_rng(0)
        st = make_store(pk, kind, tmp_path, iota_file())
        outs = []
        for _ in range(50):
            start = int(rng.integers(0, FILE_ELEMS - 2))
            n = int(rng.integers(1, min(FILE_ELEMS - start, 5000)))
            out = st.read_sync(start * 4, contiguous(pk, n * 4))
            np.testing.assert_array_equal(
                out.view(np.uint32),
                np.arange(start, start + n, dtype=np.uint32))
            outs.append(out.copy())
        st.close()
        return outs
    assert_same(*run_both(trials))


@pytest.mark.parametrize("kind", BACKENDS)
def test_strided_read_randomized(kind, tmp_path):
    def trials(pk):
        rng = np.random.default_rng(0)
        st = make_store(pk, kind, tmp_path, iota_file())
        outs = []
        for _ in range(50):
            len_el = int(rng.integers(1, 200))
            stride_el = len_el + int(rng.integers(0, 300))
            max_strides = (FILE_ELEMS - len_el) // max(stride_el, 1)
            if max_strides < 1:
                continue
            n_str = int(rng.integers(1, min(max_strides, 64) + 1))
            base = int(rng.integers(
                0, FILE_ELEMS - ((n_str - 1) * stride_el + len_el) + 1))
            out = st.read_sync(base * 4, strided(pk, stride_el * 4, n_str,
                                                 len_el * 4))
            expect = np.concatenate([
                np.arange(base + i * stride_el,
                          base + i * stride_el + len_el, dtype=np.uint32)
                for i in range(n_str)])
            np.testing.assert_array_equal(out.view(np.uint32), expect)
            outs.append(out.copy())
        st.close()
        return outs
    assert_same(*run_both(trials))


@pytest.mark.parametrize("kind", BACKENDS)
def test_write_read_back_randomized(kind, tmp_path):
    def trials(pk):
        rng = np.random.default_rng(0)
        data = iota_file()
        st = make_store(pk, kind, tmp_path, data)
        shadow = data.copy()
        for _ in range(40):
            start = int(rng.integers(0, FILE_ELEMS - 2))
            n = int(rng.integers(1, min(FILE_ELEMS - start, 3000)))
            vals = rng.integers(0, 2**32, n, dtype=np.uint32)
            st.write_sync(start * 4, contiguous(pk, n * 4),
                          vals.view(np.uint8).ravel())
            shadow[start:start + n] = vals
            lo = max(0, start - 100)
            hi = min(FILE_ELEMS, start + n + 100)
            got = st.read_sync(lo * 4, contiguous(pk, (hi - lo) * 4))
            np.testing.assert_array_equal(got.view(np.uint32),
                                          shadow[lo:hi])
        whole = st.read_sync(0, contiguous(pk, FILE_ELEMS * 4)).copy()
        st.close()
        return [whole]
    assert_same(*run_both(trials))


@pytest.mark.parametrize("kind", BACKENDS)
def test_strided_write_randomized(kind, tmp_path):
    def trials(pk):
        rng = np.random.default_rng(0)
        data = iota_file()
        st = make_store(pk, kind, tmp_path, data)
        shadow = data.copy()
        outs = []
        for _ in range(30):
            len_el = int(rng.integers(1, 100))
            stride_el = len_el + int(rng.integers(0, 200))
            n_str = int(rng.integers(1, 32))
            extent = (n_str - 1) * stride_el + len_el
            if extent >= FILE_ELEMS:
                continue
            base = int(rng.integers(0, FILE_ELEMS - extent))
            vals = rng.integers(0, 2**32, n_str * len_el, dtype=np.uint32)
            st.write_sync(base * 4, strided(pk, stride_el * 4, n_str,
                                            len_el * 4),
                          vals.view(np.uint8).ravel())
            for i in range(n_str):
                o = base + i * stride_el
                shadow[o:o + len_el] = vals[i * len_el:(i + 1) * len_el]
            got = st.read_sync(0, contiguous(pk, FILE_ELEMS * 4))
            np.testing.assert_array_equal(got.view(np.uint32), shadow)
            outs.append(got.copy())
        st.close()
        return outs
    assert_same(*run_both(trials))


@pytest.mark.parametrize("kind", ["py", "native", "native_direct"])
def test_concurrent_async_reads(kind, tmp_path):
    """Many tickets in flight at once (the queue and the pool)."""
    def trials(pk):
        rng = np.random.default_rng(0)
        st = make_store(pk, kind, tmp_path, iota_file())
        tickets, bufs, metas = [], [], []
        for _ in range(64):
            start = int(rng.integers(0, FILE_ELEMS - 1000))
            n = int(rng.integers(1, 1000))
            buf = np.empty(n * 4, dtype=np.uint8)
            tickets.append(st.read(start * 4, contiguous(pk, n * 4), buf))
            bufs.append(buf)
            metas.append((start, n))
        for t, buf, (start, n) in zip(tickets, bufs, metas):
            t.wait()
            np.testing.assert_array_equal(
                buf.view(np.uint32),
                np.arange(start, start + n, dtype=np.uint32))
        st.close()
        return bufs
    assert_same(*run_both(trials))


def test_native_concurrent_unaligned_direct_writes(tmp_path):
    """Adjacent unaligned O_DIRECT writes sharing boundary sectors must not
    corrupt each other (the engine's sector-interval locks)."""
    def trials(pk):
        n = 1 << 16
        st = make_store(pk, "native_direct", tmp_path,
                        np.zeros(n, dtype=np.uint32))
        run = 77  # 308 B runs, never sector aligned
        tickets = [st.write(i * run * 4, contiguous(pk, run * 4),
                            np.full(run, i + 1, np.uint32).view(np.uint8))
                   for i in range(n // run)]
        for t in tickets:
            t.wait()
        got = st.read_sync(0, contiguous(pk, (n // run) * run * 4))
        got = got.view(np.uint32).copy()
        st.close()
        np.testing.assert_array_equal(
            got, np.repeat(np.arange(1, n // run + 1, dtype=np.uint32), run))
        return [got]
    assert_same(*run_both(trials))


def test_memstore_grows_on_write():
    def trial(pk):
        st = pk.mod("io.store").MemStore(16)
        vals = np.arange(8, dtype=np.uint32)
        st.write_sync(8, contiguous(pk, 32), vals.view(np.uint8).ravel())
        got = st.read_sync(8, contiguous(pk, 32)).view(np.uint32).copy()
        np.testing.assert_array_equal(got, vals)
        return st.size(), got
    (ref_size, ref_got), (size, got) = run_both(trial)
    assert size == ref_size == 40
    np.testing.assert_array_equal(got, ref_got)


def test_native_kernel_aio_strided_path(tmp_path, monkeypatch):
    """Fully aligned O_DIRECT strided access takes io_submit (the engine's
    aio op counter moves) with span coalescing off, and returns exact
    data, reading and writing."""
    monkeypatch.setenv("BOF_NO_SPAN_COALESCE", "1")

    def trial(pk):
        lib = engine(pk)
        lib.bof_aio_ops.restype = ctypes.c_longlong
        native = pk.mod("io.native")
        n = 1 << 20
        data = np.arange(n, dtype=np.uint32)
        st = make_store(pk, "native_direct", tmp_path, data)
        before = lib.bof_aio_ops()
        sinfo = strided(pk, 4096, 128, 1024)
        out = native.alloc_aligned(sinfo.nbytes)
        st.read(0, sinfo, out).wait()
        used_aio = lib.bof_aio_ops() > before
        expect = np.concatenate([data[i * 1024: i * 1024 + 256]
                                 for i in range(128)])
        np.testing.assert_array_equal(out.view(np.uint32), expect)
        vals = np.random.default_rng(0).integers(0, 2**32, 128 * 256,
                                                 dtype=np.uint32)
        src = native.alloc_aligned(sinfo.nbytes)
        src[:] = vals.view(np.uint8)
        st.write(0, sinfo, src).wait()
        got = st.read_sync(0, contiguous(pk, n * 4)).view(np.uint32).copy()
        shadow = data.copy()
        for i in range(128):
            shadow[i * 1024:i * 1024 + 256] = vals[i * 256:(i + 1) * 256]
        np.testing.assert_array_equal(got, shadow)
        st.close()
        return used_aio, got
    (ref_aio, ref_got), (aio, got) = run_both(trial)
    assert aio and ref_aio, "aligned strided read did not use kernel AIO"
    np.testing.assert_array_equal(got, ref_got)


def test_native_span_coalesced_strided_read(tmp_path):
    """Dense small-run strided O_DIRECT reads are served by one sequential
    span read and a host scatter (the span counter moves), also at an
    unaligned offset whose last span runs past EOF (zeros there)."""
    data = np.random.default_rng(0).integers(0, 2**32, (12 << 20) // 4,
                                             dtype=np.uint32)

    def trial(pk):
        lib = engine(pk)
        lib.bof_span_ops.restype = ctypes.c_longlong
        st = make_store(pk, "native_direct", tmp_path, data)
        before = lib.bof_span_ops()
        got = st.read_sync(0, strided(pk, 48 << 10, 64, 16 << 10)).copy()
        spans = lib.bof_span_ops() > before
        off = data.nbytes - 63 * (48 << 10) - 100
        got2 = st.read_sync(off, strided(pk, 48 << 10, 64, 4096)).copy()
        st.close()
        return spans, got, got2, off

    (ref_spans, *ref), (spans, got, got2, off) = run_both(trial)
    assert spans and ref_spans, "span path did not engage"
    expect = np.concatenate([
        data[i * (48 << 10) // 4: i * (48 << 10) // 4 + (16 << 10) // 4]
        for i in range(64)])
    np.testing.assert_array_equal(got.view(np.uint32), expect)
    raw = data.view(np.uint8)
    pieces = []
    for i in range(64):  # bytes past EOF read back as zeros
        part = raw[off + i * (48 << 10): off + i * (48 << 10) + 4096]
        pieces.append(np.pad(part, (0, 4096 - len(part))))
    np.testing.assert_array_equal(got2, np.concatenate(pieces))
    assert_same(ref[:2], [got, got2])


def test_native_grouping_with_small_max_chunk(tmp_path):
    """max_chunk < len_per_stride < 1 MiB: every run of a group executes
    (a regression that read only the first of each)."""
    data = np.arange((4 << 20) // 4, dtype=np.uint32)
    run_el = (512 << 10) // 4

    def trial(pk):
        engine(pk)
        d = tmp_path / pk.name
        d.mkdir()
        path = str(d / "gc.bin")
        data.tofile(path)
        st = pk.mod("io.native").NativeFileStore(
            path, n_threads=4, max_chunk_bytes=256 << 10)
        got = st.read_sync(0, strided(pk, 512 << 10, 8, 512 << 10)).copy()
        got2 = st.read_sync(0, strided(pk, 768 << 10, 5, 512 << 10)).copy()
        st.close()
        return [got, got2]
    ref, port = run_both(trial)
    np.testing.assert_array_equal(port[0].view(np.uint32),
                                  data[:8 * run_el])
    np.testing.assert_array_equal(port[1].view(np.uint32), np.concatenate(
        [data[i * (768 << 10) // 4:i * (768 << 10) // 4 + run_el]
         for i in range(5)]))
    assert_same(ref, port)


@pytest.mark.parametrize("kind", BACKENDS)
def test_scopy_randomized(kind, tmp_path):
    """Strided store-to-store copies of equal total bytes, checked end to
    end."""
    data = iota_file()

    def trials(pk):
        rng = np.random.default_rng(0)
        src = make_store(pk, kind, tmp_path, data)
        (tmp_path / "dst").mkdir(exist_ok=True)
        dst = make_store(pk, kind, tmp_path / "dst", np.zeros_like(data))
        outs = []
        for _ in range(20):
            n_runs = int(rng.integers(1, 8))
            run_el = int(rng.integers(1, 512))
            s_gap = run_el + int(rng.integers(0, 64))
            d_gap = run_el + int(rng.integers(0, 64))
            s_off = int(rng.integers(0, 1024)) * 4
            d_off = int(rng.integers(0, 1024)) * 4
            s_si = strided(pk, s_gap * 4, n_runs, run_el * 4)
            d_si = strided(pk, d_gap * 4, n_runs, run_el * 4)
            src.scopy(s_off, s_si, dst, d_off, d_si).wait()
            want = np.concatenate([
                data.view(np.uint8)[s_off + i * s_gap * 4:
                                    s_off + i * s_gap * 4 + run_el * 4]
                for i in range(n_runs)])
            got = dst.read_sync(d_off, d_si)
            np.testing.assert_array_equal(got, want)
            outs.append(got.copy())
        src.close()
        dst.close()
        return outs
    assert_same(*run_both(trials))


@pytest.mark.parametrize("kind", ["mem", "py"])
def test_read_past_eof_zero_fills(kind, tmp_path):
    """Reads past EOF zero-fill the rest, contiguous and strided."""
    data = np.arange(64, dtype=np.uint32)

    def trial(pk):
        st = make_store(pk, kind, tmp_path, data)
        out = st.read_sync(128, contiguous(pk, 512)).view(np.uint32).copy()
        out2 = st.read_sync(64, strided(pk, 128, 4, 64)).view(
            np.uint32).copy()
        st.close()
        return [out, out2]
    ref, port = run_both(trial)
    np.testing.assert_array_equal(port[0][:32], data[32:])
    np.testing.assert_array_equal(port[0][32:], 0)
    np.testing.assert_array_equal(port[1][:16], data[16:32])
    assert_same(ref, port)


@pytest.mark.parametrize("kind", ["native", "native_direct"])
def test_write_verify_catches_injected_corruption(kind, tmp_path,
                                                  monkeypatch):
    """With write verification on, a clean write passes and an injected
    on-disk corruption raises IOError from the ticket, in both engines."""
    vals = np.random.default_rng(0).integers(0, 2**32, 1024,
                                             dtype=np.uint32)
    for pk in BOTH:
        lib = engine(pk)
        st = make_store(pk, kind, tmp_path, iota_file(1 << 14))
        lib.bof_set_verify_writes(1)
        try:
            st.write_sync(4096, contiguous(pk, 4096),
                          vals.view(np.uint8).ravel())
            with monkeypatch.context() as m:
                m.setenv("BOF_TEST_CORRUPT_WRITES", "1")
                with pytest.raises(IOError):
                    st.write_sync(8192, contiguous(pk, 4096),
                                  vals.view(np.uint8).ravel())
        finally:
            lib.bof_set_verify_writes(0)
        got = st.read_sync(4096, contiguous(pk, 4096)).view(np.uint32)
        np.testing.assert_array_equal(got, vals)
        st.close()


def test_native_aio_depth_knob_plumbed(tmp_path, monkeypatch):
    """A depth-2 AIO engine (max_simul_reqs) still completes a 64-run
    aligned strided read through io_submit, exactly."""
    monkeypatch.setenv("BOF_NO_SPAN_COALESCE", "1")
    data = np.arange(1 << 18, dtype=np.uint32)

    def trial(pk):
        lib = engine(pk)
        lib.bof_aio_ops.restype = ctypes.c_longlong
        lib.bof_set_aio_depth(2, 256)
        try:
            st = make_store(pk, "native_direct", tmp_path, data)
            before = lib.bof_aio_ops()
            sinfo = strided(pk, 8192, 64, 2048)
            out = pk.mod("io.native").alloc_aligned(sinfo.nbytes)
            st.read(0, sinfo, out).wait()
            used = lib.bof_aio_ops() > before
            st.close()
        finally:
            lib.bof_set_aio_depth(64, 256)
        return used, out.copy()
    (ref_used, ref_out), (used, out) = run_both(trial)
    assert used and ref_used
    np.testing.assert_array_equal(out.view(np.uint32), np.concatenate(
        [data[i * 2048: i * 2048 + 512] for i in range(64)]))
    np.testing.assert_array_equal(out, ref_out)


def test_native_zero_length_strided_submit(tmp_path):
    """Zero-length and zero-run accesses complete at once (a regression:
    the grouping divided by len_per_stride first and the process died)."""
    for pk in BOTH:
        st = make_store(pk, "native", tmp_path, iota_file(1 << 12))
        for n_runs, ln in ((2, 0), (0, 64), (0, 0)):
            si = strided(pk, 512, n_runs, ln)
            out = np.zeros(max(1, si.nbytes), np.uint8)
            st.read(0, si, out[:si.nbytes]).wait()
            st.write(0, si, out[:si.nbytes]).wait()
        np.testing.assert_array_equal(
            st.read_sync(0, contiguous(pk, 1 << 14)).view(np.uint32),
            iota_file(1 << 12))
        st.close()


def test_native_pin_oversized_raises(tmp_path):
    """The native pin cache rejects a tile larger than its budget with
    MemoryError (the Python cache's behaviour) in both packages."""
    for pk in BOTH:
        st = make_store(pk, "native", tmp_path, iota_file(1 << 14))
        nc = pk.mod("io.native_cache").NativeTileCache(4096)
        try:
            with pytest.raises(MemoryError):
                nc.pin_read(st, 0, contiguous(pk, 1 << 14))
        finally:
            nc.close()
            st.close()


def test_pystore_zero_length_ticket_completes(tmp_path):
    """Zero-byte accesses return completed tickets (a regression: the
    waiter hung)."""
    for pk in BOTH:
        st = make_store(pk, "py", tmp_path, np.arange(64, dtype=np.uint32))
        t = st.read(0, contiguous(pk, 0), np.zeros(0, np.uint8))
        assert t.done()
        t.wait()
        t2 = st.write(0, strided(pk, 64, 0, 0), np.zeros(0, np.uint8))
        assert t2.done()
        st.close()


def test_non_contiguous_buffer_rejected():
    """Strided or reversed views are refused up front with the same
    ValueError in both packages."""
    messages = []
    for pk in BOTH:
        st = pk.mod("io.store").MemStore(4096)
        base = np.zeros(1024, np.uint8)
        for bad in (base[::2], base[::-1]):
            for op in (st.read, st.write):
                with pytest.raises(ValueError, match="contiguous") as e:
                    op(0, contiguous(pk, 256), bad)
                messages.append(str(e.value))
    assert messages[:4] == messages[4:]
