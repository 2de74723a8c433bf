"""write_gbps on synthetic records: the writer's bytes over its span's
seconds, and nothing where the program books no bytes on the span."""
import pytest

from oocbench import run as R


def _read(counters, entry="gemm"):
    return R.metric_reader("write_gbps")({"entry": entry,
                                          "counters": counters,
                                          "window_s": 51.0})


@pytest.mark.parametrize("counters,entry,want", [
    ({"gemm.write_bytes": 2**30 * 128, "gemm.write_s": 8.0}, "gemm",
     2**30 * 16 / 1e9),
    ({"gemm.write_bytes": 3.4e9, "gemm.write_s": 1.0,
      "csrmm.write_bytes": 1e9, "csrmm.write_s": 10.0}, "gemm", 3.4),
    ({"csrmm.write_bytes": 1e9, "csrmm.write_s": 10.0}, "csrmm", 0.1),
])
def test_bytes_over_the_write_span_seconds(counters, entry, want):
    assert _read(counters, entry) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {}, {"gemm.write_s": 17.0},  # the span without its bytes
    {"gemm.write_bytes": 0.0, "gemm.write_s": 17.0},
    {"gemm.write_bytes": 1e9},
    {"csrmm.write_bytes": 1e9, "csrmm.write_s": 1.0}])  # another entry's
def test_nothing_to_read_without_the_write_bytes(counters):
    assert _read(counters) is None


def test_it_is_a_declared_per_layer_metric():
    m = {x["name"]: x for x in R.load_manifest()["per_layer"]}
    assert m["write_gbps"]["moves"] == "gflops"
    assert m["write_gbps"]["layer"] == "C's store"
    assert m["write_gbps"]["workloads"] == ["sgemm_fig5.resident"]
