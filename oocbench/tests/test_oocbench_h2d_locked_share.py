"""h2d_locked_share on synthetic records: the page-locked share of the
window's uploaded bytes, and nothing where the program counts no
uploads."""
import pytest

from oocbench import run as R


def _read(counters):
    return R.metric_reader("h2d_locked_share")({"counters": counters,
                                                "window_s": 51.0})


@pytest.mark.parametrize("counters,want", [
    ({"h2d.bytes": 4e9, "h2d.locked_bytes": 3e9}, 75.0),
    ({"h2d.bytes": 2.0 * 2**30, "h2d.locked_bytes": 2.0 * 2**30}, 100.0),
    ({"h2d.bytes": 1e6}, 0.0),  # uploads counted, none page-locked
])
def test_share_of_the_uploaded_bytes(counters, want):
    assert _read(counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{}, {"h2d.bytes": 0.0},
                                      {"gemm.h2d_s": 3.0}])
def test_nothing_to_read_without_counted_uploads(counters):
    assert _read(counters) is None


def test_it_is_a_declared_per_layer_metric():
    m = {x["name"]: x for x in R.load_manifest()["per_layer"]}
    assert m["h2d_locked_share"]["moves"] == "gflops"
    assert m["h2d_locked_share"]["workloads"] == [
        "sgemm_fig5.resident", "xml_amazon670k.top5"]
