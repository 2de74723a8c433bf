"""The traced run: torch.profiler over the window, reduced to a summary.

`start`/`stop` wrap `torch.profiler.profile` (CPU and CUDA activities)
around the window and export its Chrome trace; `summarize` reduces the
trace's events to what the per-layer metrics read: the traced window,
the device's busy seconds (the union of kernels, copies and memsets in
it), device seconds and launches by kernel, bytes and device seconds of
each copy direction, the top device operations and the longest idle
gaps, each gap named by what the host was in and what the device ran
next.  Only a `--trace 1` run imports this module.
"""
from __future__ import annotations

import bisect
import collections
import json

WINDOW_SPAN = "oocbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    span = torch.profiler.record_function(WINDOW_SPAN)
    span.__enter__()
    return prof, span


def stop(handle, path: str) -> dict:
    """Close the window's span and the profiler (the caller has drained
    the device) and summarize the exported trace."""
    prof, span = handle
    span.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return summarize(events)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:96]


def _copy_kind(name: str) -> str:
    for kind in ("HtoD", "DtoH", "DtoD", "HtoH"):
        if kind in name:
            return kind
    return "other"


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """The summary of a Chrome trace's events (times in microseconds)."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("ph") == "X"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d <= w0 or s >= w1:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((max(s, w0), min(s + d, w1), e))
        elif e.get("cat") == "cpu_op":
            host.append((s, s + d, e["name"]))

    kernels = collections.defaultdict(lambda: [0.0, 0])
    copies = collections.defaultdict(lambda: [0.0, 0.0, 0])
    ops = collections.defaultdict(float)
    for s, t, e in dev:
        sec = (t - s) / 1e6
        if e["cat"] == "kernel":
            name = short_name(e["name"])
            kernels[name][0] += sec
            kernels[name][1] += 1
        else:
            name = e["name"]
            if e["cat"] == "gpu_memcpy":
                c = copies[_copy_kind(name)]
                c[0] += float(e.get("args", {}).get("bytes", 0))
                c[1] += sec
                c[2] += 1
        ops[name] += sec

    merged = _union((s, t) for s, t, _ in dev)
    busy = sum(t - s for s, t in merged)
    by_start = sorted(dev, key=lambda x: x[0])
    starts = [s for s, _, _ in by_start]
    names = [short_name(e["name"]) if e["cat"] == "kernel" else e["name"]
             for _, _, e in by_start]
    host.sort()
    host_starts = [h[0] for h in host]
    longest = max((h[1] - h[0] for h in host), default=0.0)
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        j = bisect.bisect_left(starts, g1)
        nxt = names[j] if j < len(names) else "window end"
        # the host op (any thread) that overlaps the gap the most
        best, best_ov = None, 0.0
        lo = bisect.bisect_left(host_starts, g0 - longest)
        hi = bisect.bisect_right(host_starts, g1)
        for hs, he, hn in host[lo:hi]:
            ov = min(he, g1) - max(hs, g0)
            if ov > best_ov:
                best, best_ov = hn, ov
        where = best if best is not None else "no torch op"
        gaps[f"host in {where}; device next {nxt}"] += (g1 - g0) / 1e6

    def top(d):
        return [[k, v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "copies": {k: list(v) for k, v in copies.items()},
        "device_ops": top(ops),
        "idle_gaps": top(gaps),
    }
