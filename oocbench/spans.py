"""The traced run with the port's spans: every thread recorded, and each
idle gap of the card booked to the program span it waited on.

`start`/`stop` are `trace.start`/`trace.stop` with torch.profiler
recording the host events of every thread (`profile_all_threads`) and the
port's spans switched on (`bof_tpu_torch.utils.profiling.set_spans`);
`summarize` adds to `trace.summarize`'s summary

- `spans`: {span name: [host seconds inside the window, count]};
- `idle_booked`: {span name: device-idle seconds booked to it}, by `book`,
  with `no program span` for what no span explains;
- `idle_spans`: its ten largest, as [name, seconds], and `no program span`.

    python3 -m oocbench.spans --workload <cell> --seed <n> --seconds <s>

runs one traced run of a cell so, reads the cell's per-layer metrics and
the five that read the spans and the pin cache's read bytes (`NEW`), and
prints the run's line with `idle_spans` under `breakdown`.  `run.py` and
`trace.py` are not changed by this module: it swaps `trace.start`/`stop`
for its own and reads the cache's `read_bytes` through
`FlashContext.pin_cache_stats()` in `run.native_pin_cache`'s place, in
its own process only.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys

from . import run as R
from . import trace

NO_SPAN = "no program span"
HAND_OFFS = (".queue_wait", ".tile_wait")
# the metrics this run adds to the cell's: (name, unit)
NEW = [("card_wait_disk", "%"), ("card_wait_prep", "%"),
       ("card_wait_h2d", "%"), ("card_wait_d2h", "%"),
       ("pin_read_gbps", "GB/s")]


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bof_tpu_torch.utils import profiling
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=profiling.all_threads_config())
    prof.__enter__()
    was_on = profiling.set_spans(True)
    span = torch.profiler.record_function(trace.WINDOW_SPAN)
    span.__enter__()
    return prof, span, was_on


def stop(handle, path: str) -> dict:
    """trace.stop, summarized by this module's `summarize`."""
    from bof_tpu_torch.utils import profiling
    prof, span, was_on = handle
    span.__exit__(None, None, None)
    profiling.set_spans(was_on)
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])


def kind(name: str) -> str:
    """'entry' (a call: gemm, csrmm, ...), 'hand_off' (a stage waiting on
    another) or 'stage'."""
    if "." not in name:
        return "entry"
    return "hand_off" if name.endswith(HAND_OFFS) else "stage"


def _innermost(spans):
    """Per thread, non-overlapping (start, end, name, span start) pieces
    naming the innermost of `spans` (start, end, name; nested on a thread,
    as spans are) open over each."""
    out = []
    stack = []  # (end, name, start), outermost first
    t = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top, top_s = stack.pop()
            if t < end:
                out.append((t, end, top, top_s))
            t = end
        if stack and t < s:
            out.append((t, s, stack[-1][1], stack[-1][2]))
        stack.append((e, name, s))
        t = s
    while stack:
        end, top, top_s = stack.pop()
        if t < end:
            out.append((t, end, top, top_s))
        t = max(t, end)
    return out


class _Timeline:
    """A thread's innermost span at each time, for a kind of spans."""

    def __init__(self, spans):
        self.pieces = _innermost(spans)
        self.starts = [p[0] for p in self.pieces]

    def at(self, t):
        """(name, span start) of the innermost span open at t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.pieces[i][1]:
            return self.pieces[i][2], self.pieces[i][3]
        return None

    def cuts(self, g0, g1):
        i = bisect.bisect_right(self.starts, g0)
        j = bisect.bisect_left(self.starts, g1)
        return ([p[0] for p in self.pieces[i:j]]
                + [p[1] for p in self.pieces[max(i - 1, 0):j]
                   if g0 < p[1] < g1])


def book(events, w0: float, w1: float, gaps) -> dict:
    """{span name: idle seconds} of the idle `gaps` ((start, end, device op
    that ends the gap, or None at the window's end), microseconds).

    Each gap is split at span boundaries; each piece goes to the first of
    1. the innermost stage span open on the thread that issued the device
       operation ending the gap (`issuer`);
    2. else (a hand-off or an entry span innermost there, no span open,
       no issuing thread found, or the window's end) the innermost stage
       span open over the piece on any thread, the latest begun where
       several threads have one;
    3. else the entry span, if one is open;
    4. else `no program span`."""
    by_ext = {}     # External id -> the thread of the torch op carrying it
    issued_by = {}  # correlation -> (thread, start, External id) of the call
    by_tid = collections.defaultdict(lambda: collections.defaultdict(list))
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        args = e.get("args", {})
        if cat in ("cpu_op", "user_annotation") and "External id" in args:
            by_ext[args["External id"]] = e.get("tid")
        if cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                issued_by[args["correlation"]] = (
                    e.get("tid"), float(e["ts"]), args.get("External id"))
        elif cat == "user_annotation" and e["name"] != trace.WINDOW_SPAN:
            s = float(e["ts"])
            f = s + float(e["dur"])
            if f <= w0 or s >= w1:
                continue
            span = (s, f, e["name"])
            by_tid[e.get("tid")]["any"].append(span)
            by_tid[e.get("tid")][kind(e["name"])].append(span)
    innermost = {t: _Timeline(d["any"]) for t, d in by_tid.items()}
    stages = [_Timeline(d["stage"]) for d in by_tid.values()]
    entries = [_Timeline(d["entry"]) for d in by_tid.values()]

    def issuer(op):
        """The thread that issued device op `op`: that of the torch op
        whose `External id` the op (or its runtime call) carries, else the
        runtime call's own thread where a span of that thread was open at
        the call.  The tracer gives a runtime call of a thread started
        after the first ones the id of an earlier thread, which by then
        has ended and has no span open (seen with torch 2.11.0+cu128)."""
        args = op.get("args", {})
        if args.get("External id") in by_ext:
            return by_ext[args["External id"]]
        tid, t, ext = issued_by.get(args.get("correlation"),
                                    (None, None, None))
        if ext in by_ext:
            return by_ext[ext]
        if tid in innermost and innermost[tid].at(t) is not None:
            return tid
        return None

    booked = collections.defaultdict(float)
    for g0, g1, op in gaps:
        issuer_tl = innermost.get(issuer(op)) if op else None
        cuts = {g0, g1}
        for tl in innermost.values():
            cuts.update(tl.cuts(g0, g1))
        cuts = sorted(cuts)
        for p0, p1 in zip(cuts, cuts[1:]):
            mid = (p0 + p1) / 2
            got = issuer_tl.at(mid) if issuer_tl is not None else None
            if got is None or kind(got[0]) != "stage":
                open_stages = [x for x in (tl.at(mid) for tl in stages)
                               if x is not None]
                got = max(open_stages, key=lambda x: x[1], default=None)
            if got is None:
                got = next((x for x in (tl.at(mid) for tl in entries)
                            if x is not None), (NO_SPAN, 0.0))
            booked[got[0]] += (p1 - p0) / 1e6
    return dict(booked)


def summarize(events) -> dict:
    """trace.summarize's summary with `spans`, `idle_booked` and
    `idle_spans` (see the module's docstring)."""
    out = trace.summarize(events)
    win = next(e for e in events if e.get("name") == trace.WINDOW_SPAN
               and e.get("ph") == "X")
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    dev = []
    spans = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if f <= w0 or s >= w1:
            continue
        if e.get("cat") in trace.DEVICE_CATS:
            dev.append((max(s, w0), min(f, w1), e))
        elif (e.get("cat") == "user_annotation"
              and e["name"] != trace.WINDOW_SPAN):
            spans[e["name"]][0] += (min(f, w1) - max(s, w0)) / 1e6
            spans[e["name"]][1] += 1
    merged = trace._union((s, f) for s, f, _ in dev)
    firsts = sorted((s, i) for i, (s, _, _) in enumerate(dev))
    starts = [s for s, _ in firsts]
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            j = bisect.bisect_left(starts, g1)
            gaps.append((g0, g1, dev[firsts[j][1]][2]
                         if j < len(starts) else None))
    booked = book(events, w0, w1, gaps)
    top = sorted(((k, v) for k, v in booked.items() if k != NO_SPAN),
                 key=lambda kv: -kv[1])[:trace.TOP]
    out["spans"] = {k: list(v) for k, v in spans.items()}
    out["idle_booked"] = booked
    out["idle_spans"] = ([[k, v] for k, v in top]
                         + [[NO_SPAN, booked.get(NO_SPAN, 0.0)]])
    return out


class _StatsLog:
    """The native cache in the harness's hands (`run.native_pin_cache`),
    keeping each reading of the context's `pin_cache_stats()`: the
    harness reads it at the window's start and end."""

    def __init__(self, ctx, readings: list):
        self._ctx = ctx
        self._readings = readings

    def stats(self) -> dict:
        s = self._ctx.pin_cache_stats()
        self._readings.append(s)
        return s


def traced_run(config, mix, seed, seconds, device="cuda", log=print):
    """run.run's traced run with this module's recording; the record
    carries `pin_read_bytes`, the window's change of the cache's
    `read_bytes`."""
    readings: list = []
    saved = trace.start, trace.stop, R.native_pin_cache

    def native_pin_cache(ctx):
        return None if saved[2](ctx) is None else _StatsLog(ctx, readings)
    trace.start, trace.stop = start, stop
    R.native_pin_cache = native_pin_cache
    try:
        rec = R.run(config, mix, seed, seconds, True, device=device,
                    log=log)
    finally:
        trace.start, trace.stop, R.native_pin_cache = saved
    rec["pin_read_bytes"] = (readings[-1]["read_bytes"]
                             - readings[0]["read_bytes"]
                             if len(readings) >= 2 else None)
    return rec


def line(rec, metrics, device) -> dict:
    out = R.result_line(rec, metrics + NEW, device, True)
    out["breakdown"]["idle_spans"] = rec["trace"]["idle_spans"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    try:
        manifest = R.load_manifest()
        cell, config, mix = R.resolve(manifest, args.workload)
        R.require_card(cell["chips"])
        import torch
        rec = traced_run(config, mix, args.seed, args.seconds,
                         log=lambda s: print(s, file=sys.stderr, flush=True))
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell["chips"],
                  "memory_peak_bytes": rec["device_peak_bytes"],
                  "busy_s": rec["trace"]["busy_s"],
                  "window_s": rec["trace"]["window_s"]}
        out = line(rec, R.cell_metrics(manifest, args.workload, True),
                   device)
    except R.Refused as e:
        print(f"[oocbench] no result: {e}", file=sys.stderr, flush=True)
        return e.code
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
