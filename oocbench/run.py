"""One run of one cell of bof_tpu_torch's benchmark.

    python3 -m oocbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`.  The run finds
the card (or exits 2), loads the port's kernels from `build/` in the
checkout (building them on a new checkout), makes the cell's operands on
the card from the seed and writes them as raw files into a directory of
its own under `build/oocbench/runs/`, opens a `FlashContext` with the
mix's Program Cache, warms up with one call, then calls the cell's entry
back to back for `--seconds` (the last call finishes), judges a seeded
sample of every call's output against the float64 reference, and prints
one JSON line last: the end-to-end metrics with `--trace 0`, the
per-layer ones (under torch.profiler) with `--trace 1`.

Everything of one configuration, traffic mix, entry or metric sits in a
file of its own (`configs/`, `mixes/`, `entries/`, `metrics/`), found by
the names in `BENCHMARK.json`.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bof_tpu")
WRITE_LIMIT = 4 << 30   # bytes a run may write, set-up and window together
CAP = 256               # calls whose output sample is kept and judged
PORT = "bof_tpu_torch"
IO_KEYS = ("rchar", "wchar", "read_bytes", "write_bytes")


class Refused(Exception):
    """A run that must print no result: its exit code and reason."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


@dataclasses.dataclass
class Run:
    """What an entry sees of the run."""
    config: dict
    mix: dict
    seed: int
    device: object          # torch.device
    dir: str                # this run's directory (operands, scratch)
    port: object = None     # the bof_tpu_torch module
    ctx: object = None      # its FlashContext


# --------------------------------------------------------------- lookup
def _json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_manifest() -> dict:
    return _json("BENCHMARK.json")


def resolve(manifest: dict, workload: str):
    """(cell, configuration, mix) of the cell named `workload`."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = _json(conf["file"])
    mix = _json("oocbench", "mixes", cell["traffic"] + ".json")
    return cell, config, mix


def _module(kind: str, name: str):
    """oocbench/<kind>/<name>.py, loaded by its path (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"oocbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(name: str):
    return _module("entries", name)


def metric_reader(name: str):
    return _module("metrics", name).read


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The (name, unit) of each metric this cell reports in this run."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if workload in m.get("workloads", [workload])]


# --------------------------------------------------------------- probes
def proc_io() -> dict:
    """/proc/self/io's counters (the card's user-space kernel names
    rchar `char`); a counter it lacks reads 0."""
    out = dict.fromkeys(IO_KEYS, 0)
    with open("/proc/self/io") as f:
        for line in f:
            key, _, val = line.partition(":")
            key = "rchar" if key.strip() == "char" else key.strip()
            out[key] = int(val)
    return out


def written(a: dict, b: dict) -> int:
    """Bytes written between two /proc/self/io readings: the storage
    layer's count where the kernel keeps one, else (a user-space kernel on
    a 9p root, as on the card's machines) the bytes handed to write
    calls."""
    return max(b["write_bytes"] - a["write_bytes"], b["wchar"] - a["wchar"])


def process_age_s() -> float:
    """Seconds since this process started (kernel clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


class RssPeak:
    """The process's peak resident memory over a span.  The card's
    machines refuse /proc/self/clear_refs, so the kernel's own peak
    (getrusage's ru_maxrss) cannot be reset at the window's start: where
    it rises during the span it is the span's peak; else the span's peak
    is the largest of /proc/self/statm read every `interval` seconds by a
    thread of its own (a read costs up to 16 ms of the sandbox's kernel
    on a large address space, so the reads stay rare)."""

    def __init__(self, interval: float = 0.25):
        import threading
        self.interval = interval
        self.peak = 0
        self.reads = 0
        self.read_s = 0.0     # the sampler's own time in its reads
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def max_rss() -> int:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _sample(self) -> None:
        while not self._stop.wait(self.interval):
            t = time.perf_counter()
            self.peak = max(self.peak, self.rss())
            self.read_s += time.perf_counter() - t
            self.reads += 1

    def __enter__(self):
        self.max0 = self.max_rss()
        self.peak = self.rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.sampled = max(self.peak, self.rss())
        self.max1 = self.max_rss()
        self.peak = self.max1 if self.max1 > self.max0 else self.sampled


def native_pin_cache(ctx):
    """The context's native pin cache ("Program Cache"), whose `stats()`
    counts hits, misses and evictions, or None where the port does not
    expose one: the pin-cache metrics are then left out of the line."""
    cache = getattr(ctx.pin_cache(), "_nat", None)
    return cache if callable(getattr(cache, "stats", None)) else None


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def card_name_and_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def require_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refused(2, "no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise Refused(2, f"the cell needs {chips} card(s), "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")


# ----------------------------------------------------------- the checkout
def set_build_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["BOF_TORCH_BUILD"] = os.path.join(build, PORT)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def run_dir(root: str) -> str:
    """build/oocbench/runs/<pid>, after removing those of ended runs."""
    base = os.path.join(root, "build", "oocbench", "runs")
    os.makedirs(base, exist_ok=True)
    for name in os.listdir(base):
        try:
            os.kill(int(name), 0)
            alive = int(name) != os.getpid()
        except (ValueError, ProcessLookupError):
            alive = False
        except PermissionError:
            alive = True
        if not alive:
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    path = os.path.join(base, str(os.getpid()))
    os.makedirs(path)
    return path


# ---------------------------------------------------------------- judging
def rel_err(got, want) -> float:
    """max |got - want| / max |want| over one call's sample; inf where the
    sample holds a non-finite value."""
    import numpy as np
    got = np.asarray(got, np.float64)
    if not np.isfinite(got).all():
        return float("inf")
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (scale if scale > 0 else 1.0)


def call_rng(seed: int, i: int):
    import numpy as np
    return np.random.default_rng(np.random.SeedSequence([seed, 7, i]))


# ------------------------------------------------------------------- run
def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict | None = None,
        log=print) -> dict:
    """One run; returns the record the metrics read (with the judged
    readings under "checks").  `device` 'cpu' runs the port's plain
    kernels (tests); `overrides` are FlashConfig fields set last (the
    control)."""
    import numpy as np
    import torch
    set_build_env(ROOT)
    port = importlib.import_module(PORT)
    from bof_tpu_torch.utils import METRICS
    dev = torch.device(device)
    entry = entry_module(mix["entry"])
    is_cuda = dev.type == "cuda"
    if is_cuda:
        from bof_tpu_torch.ops import cuda_lib
        cuda_lib.build()
        log(f"[oocbench] card {card_name_and_limit()}")
    io_start = proc_io()
    path = run_dir(ROOT)
    r = Run(config=config, mix=mix, seed=seed, device=dev, dir=path,
            port=port)
    ctx = None
    try:
        made = entry.make(r)
        if is_cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        fields = dict(device=device, io_backend="native", use_o_direct=True,
                      sparse_compute="device",
                      scratch_dir=os.path.join(path, "scratch"),
                      program_budget=int(mix["program_budget_ratio"]
                                         * made["operand_bytes"]))
        fields.update(mix.get("flash_config", {}))
        fields.update(overrides or {})
        ctx = port.FlashContext(port.FlashConfig(**fields))
        r.ctx = ctx
        ops = entry.open_operands(r, made)
        entry.call(r, ops, -1)                      # warm-up
        if is_cuda:
            torch.cuda.synchronize()
        cache = native_pin_cache(ctx)
        io_setup = proc_io()
        setup_written = written(io_start, io_setup)
        if setup_written > WRITE_LIMIT:
            raise Refused(4, f"set-up wrote {setup_written} bytes, over "
                             f"{WRITE_LIMIT}")
        # touched now, so the window's resident memory does not grow
        # with the number of calls it judges
        samples = np.zeros((CAP,) + tuple(entry.sample_shape(r)),
                           np.float32)
        samples.fill(0.0)

        # ------------------------------------------------- the window
        m0 = METRICS.snapshot()
        pc0 = cache.stats() if cache is not None else None
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        raised = {}
        call_s, call_cpu = [], []   # each call's seconds, process CPU s
        handle = summary = None
        with RssPeak() as rss:
            if trace:
                from . import trace as tr
                handle = tr.start()
            try:
                setup_s = process_age_s()
                io0 = proc_io()
                i = 0
                t0 = time.perf_counter()
                deadline = t0 + seconds
                while time.perf_counter() < deadline:
                    pos = (entry.positions(r, call_rng(seed, i))
                           if i < CAP else None)
                    if pos is not None:
                        entry.poison(r, ops, pos)
                    tc = time.perf_counter()
                    cpu0 = time.process_time()
                    try:
                        entry.call(r, ops, i)
                    except Exception:  # counted; the window goes on
                        raised[i] = traceback.format_exc(limit=4)
                    else:
                        if pos is not None:
                            samples[i] = entry.read(r, ops, pos)
                    call_s.append(time.perf_counter() - tc)
                    call_cpu.append(time.process_time() - cpu0)
                    i += 1
                if is_cuda:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                io1 = proc_io()
            finally:
                if handle is not None:
                    summary = tr.stop(handle,
                                      os.path.join(path, "trace.json"))
        host_peak = rss.peak
        device_peak = (torch.cuda.max_memory_allocated()
                       if is_cuda else 0)
        counters = {k: v - m0.get(k, 0.0)
                    for k, v in METRICS.snapshot().items()}
        attempted = i
        pin = None
        if cache is not None:
            pc1 = cache.stats()
            pin = {k: pc1[k] - pc0[k] for k in ("hits", "misses",
                                                 "evictions")}
            # the bytes of the pins that missed: a miss reads one pin's
            # bytes, the entry's `pin_bytes`, or else the mean of the
            # lookups over which each call pins its `pinned_bytes` once
            # (exact where a call's pins share one size or all miss)
            if "pin_bytes" in made:
                pin["miss_bytes"] = pin["misses"] * made["pin_bytes"]
            else:
                lookups = pin["hits"] + pin["misses"]
                pin["miss_bytes"] = (pin["misses"] * made["pinned_bytes"]
                                     * attempted // max(lookups, 1))

        # ---------------------------- free the program, then judge
        del ops
        ctx.destroy()
        ctx = None
        if is_cuda:
            torch.cuda.empty_cache()
        judged = [(j, entry.positions(r, call_rng(seed, j)))
                  for j in range(min(attempted, CAP)) if j not in raised]
        want = entry.expected(r, judged) if judged else []
        errs = {j: rel_err(samples[j], w)
                for (j, _), w in zip(judged, want)}
        limit = mix["limits"]["rel_err"]
        failed = sorted(set(raised) | {j for j, e in errs.items()
                                       if not e <= limit})
        worst = max(errs.values(), default=float("inf"))
        window_written = written(io0, io1)
        log(f"[oocbench] write_bytes setup={setup_written} "
            f"window={window_written} limit={WRITE_LIMIT}")
        if setup_written + window_written > WRITE_LIMIT:
            raise Refused(4, f"the run wrote {setup_written + window_written}"
                             f" bytes, over {WRITE_LIMIT}")
        log(f"[oocbench] window io " + " ".join(
            f"{k}={io1[k] - io0[k]}" for k in IO_KEYS)
            + f" pin_cache={pin} operand_bytes={made['operand_bytes']}")
        log("[oocbench] call_s " + " ".join(f"{t:.3f}" for t in call_s))
        log("[oocbench] call_cpu_s "
            + " ".join(f"{t:.3f}" for t in call_cpu))
        log(f"[oocbench] rss sampler reads={rss.reads} "
            f"read_s={rss.read_s:.3f} window_s={t1 - t0:.3f} "
            f"sampled_peak={rss.sampled} maxrss_start={rss.max0} "
            f"maxrss_end={rss.max1}")
        for j in sorted(raised)[:3]:
            log(f"[oocbench] call {j} raised:\n{raised[j]}")
        return {
            "entry": mix["entry"], "shape": made["shape"],
            "operand_bytes": made["operand_bytes"],
            "work_per_call": made["work"],
            "attempted": attempted, "failed": len(failed),
            "work_passed": made["work"] * (attempted - len(failed)),
            "window_s": t1 - t0, "setup_s": setup_s,
            "io": {k: io1[k] - io0[k] for k in IO_KEYS},
            "pin_cache": pin, "counters": counters,
            "host_peak_bytes": host_peak, "device_peak_bytes": device_peak,
            "trace": summary,
            "checks": {
                "rel_err": {"value": worst, "limit": limit},
                "failed_calls": {"value": len(failed), "limit": 0},
                "judged_calls": {"value": len(errs), "limit": 1},
            },
        }
    finally:
        if ctx is not None:
            ctx.destroy()
        shutil.rmtree(path, ignore_errors=True)


def result_line(rec: dict, metrics: list, device: dict,
                trace: bool) -> dict:
    """The contract's last line (`checks` last)."""
    out = {}
    for name, unit in metrics:
        value = metric_reader(name)(rec)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    checks = rec["checks"]
    correct = (rec["attempted"] > 0 and rec["failed"] == 0
               and checks["judged_calls"]["value"] >= 1)
    line = {"correct": correct, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": out, "device": device}
    if trace and rec["trace"] is not None:
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        manifest = load_manifest()
        cell, config, mix = resolve(manifest, args.workload)
        require_card(cell["chips"])
        import torch
        rec = run(config, mix, args.seed, args.seconds,
                  bool(args.trace),
                  log=lambda s: print(s, file=sys.stderr, flush=True))
        found = forbidden_modules()
        if found:
            raise Refused(3, f"modules loaded that must not be: {found}")
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell["chips"],
                  "memory_peak_bytes": rec["device_peak_bytes"]}
        if args.trace:
            device["busy_s"] = rec["trace"]["busy_s"]
            device["window_s"] = rec["trace"]["window_s"]
        line = result_line(rec, cell_metrics(manifest, args.workload,
                                             bool(args.trace)),
                           device, bool(args.trace))
    except Refused as e:
        print(f"[oocbench] no result: {e}", file=sys.stderr, flush=True)
        return e.code
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
