"""The port's flash arrays (`bof_tpu_torch/core/flash_array.py` and the root
`flash_empty`/`flash_free`/`map_array`/`mem_array`) against bof_tpu's,
case for case after tests/test_flash_array.py: the same block reads and
writes, files, leading-dimension views, scratch arrays and memory maps on
both packages must leave the same bytes."""
import numpy as np
import pytest

from torch_pair import BOTH


@pytest.fixture
def contexts(tmp_path):
    ctxs = {pk.name: pk.context(tmp_path / f"{pk.name}_scratch")
            for pk in BOTH}
    yield ctxs
    for c in ctxs.values():
        c.destroy()


def on_both(contexts, body):
    """Each package's result of body(pk, ctx); the port's must equal the
    reference's element for element (lists of arrays)."""
    ref, port = (body(pk, contexts[pk.name]) for pk in BOTH)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p, r)
    return port


@pytest.mark.parametrize("order", ["R", "C"])
def test_roundtrip_blocks(order, contexts):
    rng = np.random.default_rng(0)
    m, n = 64, 48
    ref = rng.standard_normal((m, n)).astype(np.float32)
    patch = rng.standard_normal((10, 5)).astype(np.float32)

    def body(pk, ctx):
        arr = pk.bt.mem_array((m, n), np.float32, order, data=ref, ctx=ctx)
        whole, blk = arr.read_all(), arr.read_block(16, 32, 8, 24)
        arr.write_block(3, patch, 7)
        return [whole, blk, arr.read_all()]
    whole, blk, after = on_both(contexts, body)
    want = ref.copy()
    want[3:13, 7:12] = patch
    np.testing.assert_array_equal(whole, ref)
    np.testing.assert_array_equal(blk, ref[16:48, 8:32])
    np.testing.assert_array_equal(after, want)


@pytest.mark.parametrize("order", ["R", "C"])
def test_file_backed(order, contexts, tmp_path):
    m, n = 33, 21  # deliberately unaligned
    ref = np.random.default_rng(0).standard_normal((m, n)).astype(np.float32)

    def body(pk, ctx):
        path = str(tmp_path / f"{pk.name}_arr.bin")
        arr = pk.bt.map_array(path, (m, n), np.float32, order, create=True,
                              ctx=ctx)
        arr.write_all(ref)
        arr.store.flush()
        arr2 = pk.bt.map_array(path, (m, n), np.float32, order, ctx=ctx)
        out = [arr2.read_all(), arr2.read_block(5, 11, 2, 13),
               np.fromfile(path, np.uint8)]
        arr.store.close()
        arr2.store.close()
        return out
    whole, blk, _ = on_both(contexts, body)
    np.testing.assert_array_equal(whole, ref)
    np.testing.assert_array_equal(blk, ref[5:16, 2:15])


def test_lda_subview(contexts):
    """A sub-matrix of a larger matrix through ld, read and written."""
    rng = np.random.default_rng(0)
    big = rng.standard_normal((40, 50)).astype(np.float32)
    patch = rng.standard_normal((20, 30)).astype(np.float32)

    def body(pk, ctx):
        arr = pk.bt.mem_array((40, 50), np.float32, "R", data=big, ctx=ctx)
        sub = pk.bt.FlashArray(arr.store, (20, 30), np.float32, "R",
                               offset=(4 * 50 + 6) * 4, ld=50, ctx=ctx)
        seen = sub.read_all()
        sub.write_all(patch)
        return [seen, arr.read_all()]
    seen, after = on_both(contexts, body)
    np.testing.assert_array_equal(seen, big[4:24, 6:36])
    want = big.copy()
    want[4:24, 6:36] = patch
    np.testing.assert_array_equal(after, want)


def test_scratch_alloc(contexts):
    def body(pk, ctx):
        arr = pk.bt.flash_empty((100,), np.float32, ctx=ctx)
        arr.write_all(np.arange(100, dtype=np.float32))
        got = arr.read_all()
        pk.bt.flash_free(arr)
        return [got]
    (got,) = on_both(contexts, body)
    np.testing.assert_array_equal(got, np.arange(100, dtype=np.float32))


def test_1d_vec_view(contexts):
    def body(pk, ctx):
        arr = pk.bt.mem_array((100,), np.int32,
                              data=np.arange(100, dtype=np.int32), ctx=ctx)
        return [arr.vec_view(10, 20).read_all()]
    (got,) = on_both(contexts, body)
    np.testing.assert_array_equal(got, np.arange(10, 30, dtype=np.int32))


def test_as_memmap_raw_access(contexts, tmp_path):
    """Direct mmap access to a file array, row- and column-major."""
    ref = np.random.default_rng(0).standard_normal((20, 12)).astype(
        np.float32)

    def body(pk, ctx):
        arr = pk.bt.map_array(str(tmp_path / f"{pk.name}_mm.bin"), (20, 12),
                              np.float32, "R", create=True, ctx=ctx)
        arr.write_all(ref)
        arr.store.flush()
        mm = arr.as_memmap()
        seen = np.asarray(mm).copy()
        mm[3, 4] = 42.0
        mm.flush()
        arr_c = pk.bt.map_array(str(tmp_path / f"{pk.name}_mmc.bin"),
                                (7, 9), np.float32, "C", create=True,
                                ctx=ctx)
        arr_c.write_all(ref[:7, :9])
        arr_c.store.flush()
        return [seen, arr.read_block(3, 1, 4, 1),
                np.asarray(arr_c.as_memmap()).copy()]
    seen, poked, col = on_both(contexts, body)
    np.testing.assert_array_equal(seen, ref)
    assert poked[0, 0] == 42.0
    np.testing.assert_array_equal(col, ref[:7, :9])


def test_as_memmap_honors_ld(contexts, tmp_path):
    """A memmap of an ld-padded sub-matrix sees and writes only its own
    bytes."""
    parent_np = np.random.default_rng(0).standard_normal((10, 12)).astype(
        np.float32)

    def body(pk, ctx):
        path = str(tmp_path / f"{pk.name}_mm.bin")
        parent_np.tofile(path)
        parent = pk.bt.map_array(path, (10, 12), np.float32, "R", ctx=ctx)
        sub = pk.bt.FlashArray(parent.store, (4, 5), np.float32, "R",
                               offset=(2 * 12 + 3) * 4, ld=12, ctx=ctx)
        seen = np.asarray(sub.as_memmap(mode="r")).copy()
        mm2 = sub.as_memmap(mode="r+")
        mm2[:] = 7.0
        del mm2
        return [seen, np.fromfile(path, np.float32).reshape(10, 12)]
    seen, after = on_both(contexts, body)
    np.testing.assert_array_equal(seen, parent_np[2:6, 3:8])
    want = parent_np.copy()
    want[2:6, 3:8] = 7.0
    np.testing.assert_array_equal(after, want)
