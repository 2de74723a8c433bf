"""Checks of `BENCHMARK.json` against the benchmark's contract.

`problems(manifest, root)` lists every breach it finds (an empty list is
a sound manifest): the keys of each entry, name and unit characters,
lengths, files under `paths`, cells that name real configurations and
mixes, per-layer metrics that move an end-to-end metric every cell of
theirs reports, and the share of cells on four chips.
"""
from __future__ import annotations

import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text, lo=1, hi=200) -> bool:
    return (isinstance(text, str) and lo <= len(text) <= hi
            and "\n" not in text and "\t" not in text)


def problems(m: dict, root: str) -> list:
    out = []

    def need(ok, what):
        if not ok:
            out.append(what)

    need(set(m) == TOP_KEYS, f"top-level keys {sorted(m)}")
    paths = m.get("paths", [])
    need(1 <= len(paths) <= 16, "1 to 16 paths")
    for p in paths:
        need(bool(PATH.match(p)) and not p.startswith("/")
             and ".." not in p.split("/"), f"path {p!r}")
    cmd = m.get("command", [])
    need(1 <= len(cmd) <= 32 and all(_line(w) for w in cmd), "command")
    rs = m.get("run_seconds")
    need(isinstance(rs, int) and 1 <= rs <= 51, "run_seconds 1..51")

    def under_paths(f):
        return any(f == p or f.startswith(p.rstrip("/") + "/")
                   for p in paths)

    names = set()
    configs = m.get("configs", [])
    need(1 <= len(configs) <= 24, "1 to 24 configs")
    files = set()
    for c in configs:
        need(set(c) == CONFIG_KEYS, f"config keys {sorted(c)}")
        need(bool(NAME.match(c["name"])), f"config name {c['name']!r}")
        need(_line(c["source"]) and _line(c["why"]),
             f"config {c['name']} source/why")
        need(under_paths(c["file"])
             and os.path.isfile(os.path.join(root, c["file"])),
             f"config file {c['file']}")
        need(c["file"] not in files, f"config file {c['file']} shared")
        files.add(c["file"])
        need(len(c["reduced"]) <= 16
             and all(NAME.match(k) for k in c["reduced"]),
             f"config {c['name']} reduced")
        need(c["name"] not in names, f"name {c['name']} twice")
        names.add(c["name"])
        with open(os.path.join(root, c["file"])) as f:
            body = json.load(f)
        need(sorted(body.get("reduced", [])) == sorted(c["reduced"]),
             f"config {c['name']}: reduced differs from its file")
    cfg_names = {c["name"] for c in configs}

    cells = m.get("workloads", [])
    need(1 <= len(cells) <= 24, "1 to 24 workloads")
    pairs = set()
    for w in cells:
        need(set(w) == CELL_KEYS, f"workload keys {sorted(w)}")
        need(bool(NAME.match(w["name"])), f"workload name {w['name']!r}")
        need(w["config"] in cfg_names, f"{w['name']}: config {w['config']}")
        need(bool(NAME.match(w["traffic"])), f"traffic {w['traffic']!r}")
        need(os.path.isfile(os.path.join(root, "oocbench", "mixes",
                                         w["traffic"] + ".json")),
             f"{w['name']}: no mix file for {w['traffic']}")
        need(w["chips"] in (1, 4), f"{w['name']}: chips")
        need(_line(w["why"]), f"{w['name']}: why")
        need((w["config"], w["traffic"]) not in pairs,
             f"{w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        need(w["name"] not in names, f"name {w['name']} twice")
        names.add(w["name"])
    four = sum(w["chips"] == 4 for w in cells)
    need(four <= max(1, len(cells) // 4), "too many cells on four chips")
    used = {w["config"] for w in cells}
    need(used == cfg_names, "a configuration no cell uses")
    cell_names = {w["name"] for w in cells}

    e2e = m.get("end_to_end", [])
    need(1 <= len(e2e) <= 16, "1 to 16 end-to-end metrics")
    reports = {}
    for e in e2e:
        need(set(e) - {"workloads"} == E2E_KEYS, f"metric keys {sorted(e)}")
        need(bool(NAME.match(e["name"])) and bool(UNIT.match(e["unit"])),
             f"metric {e['name']!r} name/unit")
        need(e["better"] in ("lower", "higher"), f"{e['name']}: better")
        need(e["source"] in ("host_clock", "device_trace"),
             f"{e['name']}: source")
        need(0 < e["bound"] <= 0.25, f"{e['name']}: bound")
        need(set(e.get("workloads", cell_names)) <= cell_names,
             f"{e['name']}: workloads")
        reports[e["name"]] = set(e.get("workloads", cell_names))
        need(e["name"] not in names, f"name {e['name']} twice")
        names.add(e["name"])
        need(os.path.isfile(os.path.join(root, "oocbench", "metrics",
                                         e["name"] + ".py")),
             f"{e['name']}: no reader")
    need("setup_s" in reports, "no setup_s")
    for w in cell_names:
        need(sum(w in r for r in reports.values()) >= 2,
             f"{w}: setup_s and one more end-to-end metric")

    layers = m.get("per_layer", [])
    need(1 <= len(layers) <= 128, "1 to 128 per-layer metrics")
    has_layer = set()
    for p in layers:
        need(set(p) - {"workloads"} == LAYER_KEYS,
             f"metric keys {sorted(p)}")
        need(bool(NAME.match(p["name"])) and bool(UNIT.match(p["unit"])),
             f"metric {p['name']!r} name/unit")
        need(p["better"] in ("lower", "higher"), f"{p['name']}: better")
        need(p["source"] in SOURCES, f"{p['name']}: source")
        need(_line(p["layer"]), f"{p['name']}: layer")
        need(p["moves"] in reports, f"{p['name']}: moves {p['moves']}")
        cells_of = set(p.get("workloads", reports.get(p["moves"], set())))
        need(cells_of <= reports.get(p["moves"], set()),
             f"{p['name']}: a cell of its does not report {p['moves']}")
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            need(p["unit"] == "%", f"{p['name']}: unit %")
        has_layer |= cells_of
        need(p["name"] not in names, f"name {p['name']} twice")
        names.add(p["name"])
        need(os.path.isfile(os.path.join(root, "oocbench", "metrics",
                                         p["name"] + ".py")),
             f"{p['name']}: no reader")
    need(has_layer == cell_names, "a cell with no per-layer metric")
    return out
