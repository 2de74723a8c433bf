"""band_reuse_share on synthetic records: the share of xml_rank's band
launches served from kept bands, and nothing where the program counts no
bands."""
import pytest

from oocbench import run as R


def _read(counters):
    return R.metric_reader("band_reuse_share")({"counters": counters,
                                                "window_s": 51.0})


@pytest.mark.parametrize("counters,want", [
    # 37 calls of 6 bands, built on the first of 12 panels
    ({"xml_rank.bands_built": 222.0, "xml_rank.bands_reused": 2442.0},
     100.0 * 11 / 12),
    ({"xml_rank.bands_built": 72.0}, 0.0),  # every panel bands anew
    ({"xml_rank.bands_built": 3.0, "xml_rank.bands_reused": 1.0}, 25.0),
])
def test_share_of_the_band_launches(counters, want):
    assert _read(counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [
    {}, {"xml_rank.prep_s": 33.0},
    {"xml_rank.bands_built": 0.0, "xml_rank.bands_reused": 0.0}])
def test_nothing_to_read_without_counted_bands(counters):
    assert _read(counters) is None


def test_it_is_a_declared_per_layer_metric():
    m = {x["name"]: x for x in R.load_manifest()["per_layer"]}
    assert m["band_reuse_share"]["moves"] == "gflops"
    assert m["band_reuse_share"]["layer"] == "host prep"
    assert m["band_reuse_share"]["workloads"] == ["xml_amazon670k.top5"]
