"""The harness: finding a cell's files by name, the device checks, one
run's set-up, window, readings and check, and the result line."""
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import torch

from .capture import Sites

__all__ = ["load_cell", "require_cards", "load_config_module", "run_cell",
           "refuse_jax", "emit", "FORBIDDEN"]

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvedit_tpu")
GIB = float(1 << 30)


def _load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(manifest_path, workload):
    """The cell's entry of the manifest with its configuration, traffic mix
    and metrics resolved by name."""
    with open(manifest_path) as f:
        man = json.load(f)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        sys.exit(f"portbench: no workload {workload!r} in {manifest_path}")
    cell = dict(cells[workload])
    cfg = {c["name"]: c for c in man["configs"]}[cell["config"]]
    root = os.path.dirname(os.path.abspath(manifest_path))
    with open(os.path.join(root, cfg["file"])) as f:
        cell["config_data"] = json.load(f)
    with open(os.path.join(PB, "traffic", f"{cell['traffic']}.json")) as f:
        cell["traffic_data"] = json.load(f)

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]
    cell["end_to_end"] = [m for m in man["end_to_end"] if reports(m)]
    cell["per_layer"] = [m for m in man["per_layer"] if reports(m)]
    return cell


def require_cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"portbench: the cell needs {n} CUDA device(s); "
                         f"this machine has {have}\n")
        sys.exit(3)


def load_config_module(name):
    return _load_file(os.path.join(PB, "configs", f"{name}.py"),
                      f"portbench_config_{name}")


def load_loop(name):
    return _load_file(os.path.join(PB, "loops", f"{name}.py"),
                      f"portbench_loop_{name}")


def load_metric(name):
    return _load_file(os.path.join(PB, "metrics", f"{name}.py"),
                      f"portbench_metric_{name.replace('.', '_')}")


def refuse_jax():
    """Exit without a result if the process holds JAX or the JAX package
    (top-level module names compared whole)."""
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        sys.stderr.write(f"portbench: the process loaded {found}; the "
                         f"benchmark runs the port alone\n")
        sys.exit(4)


def device_info(device, peak):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Hooks:
    """Per-request bookkeeping of the window: the sites' request index,
    and in the traced run a request range, tick marks and a phase timer
    per request."""

    def __init__(self, sites, system, trace):
        self.sites, self.system, self.trace = sites, system, trace
        self.phases = []

    @contextmanager
    def request(self, i):
        self.sites.request = i
        timer = self.system.phase_timer(self.trace) if self.trace else None
        rng = (torch.profiler.record_function("portbench.request")
               if self.trace else nullcontext())
        with rng:
            yield
        if timer is not None:
            self.phases.append(dict(timer.report()))
            self.system.phase_timer(None)

    def capture_seconds(self, i):
        """Host seconds the benchmark spent copying captures in request
        `i`."""
        return self.sites.capture_s.get(i, 0.0)


def run_cell(cell, system, args, device, workdir, t_start):
    traffic = cell["traffic_data"]
    if args.preset == "tiny":
        traffic = dict(traffic, **traffic.get("tiny", {}))
    trace = bool(args.trace)
    sites = Sites(args.seed, tracing=trace)
    system.install(sites, traffic)
    loop = load_loop(traffic["loop"]).Loop(system, traffic, args.seed,
                                           workdir, device)
    hooks = Hooks(sites, system, trace)
    marks = {}

    def begin():
        """Set-up ends and the window opens."""
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        marks["setup_s"] = time.perf_counter() - t_start
        sites.in_window = True
        if trace:
            from .trace import Trace
            marks["tracer"] = Trace().__enter__()

    def end():
        """The window closes."""
        if trace:
            t_stop = time.perf_counter()
            marks["tracer"].__exit__(None, None, None)
            marks["stop_s"] = time.perf_counter() - t_stop
        sites.in_window = False

    win = loop.run(args.seconds, hooks, begin, end)
    setup_s, tracer = marks["setup_s"], marks.get("tracer")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    sites.restore()
    captures = sites.captures()
    ctx = dict(records=win["records"], win=win, phases=hooks.phases,
               sites=sites, system=system)
    if trace:
        t_read = time.perf_counter()
        ctx["trace"] = tracer.read()
        tracer = marks["tracer"] = None
        ctx["trace_read_s"] = time.perf_counter() - t_read
    # the program's state goes before the reference runs
    system.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        metrics, t_read = {}, time.perf_counter()
        for m in cell["per_layer"]:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        ctx["metrics_read_s"] = time.perf_counter() - t_read
    else:
        walls = [r["wall"] for r in win["records"]]
        e2e = dict(setup_s=setup_s, peak_mem_gib=peak / GIB,
                   request_s=sum(walls) / len(walls) if walls else None,
                   **win.get("end_to_end", {}))
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]
                   if e2e.get(m["name"]) is not None}
    numbers = system.compare(captures, control=args.control)
    if getattr(args, "readings", 0):
        for k, v in system.compare(captures, control=1).items():
            sys.stderr.write(f"control {k} {v!r}\n")
    limits = traffic["limits"]
    check = {k: {"value": numbers.get(k), "limit": lim}
             for k, lim in limits.items()}
    outputs_ok = all(r["ok"] for r in win["records"]) and win["failed"] == 0
    correct = outputs_ok and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in check.values())
    res = {"correct": bool(correct), "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics,
           "device": device_info(device, peak)}
    if trace:
        tr = ctx["trace"]
        res["device"]["busy_s"] = tr["busy_s"]
        res["device"]["window_s"] = tr["window_s"]
        res["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        sys.stderr.write(
            f"portbench: profiler stopped in {marks['stop_s']:.3f} s, trace "
            f"read in {ctx['trace_read_s']:.3f} s, metrics "
            f"in {ctx['metrics_read_s']:.3f} s; device "
            f"time not matched to a launch {tr['unmatched_s']:.6f} s, "
            f"launched outside the benchmark's ranges "
            f"{tr['unranged_s']:.6f} s; "
            f"ranges' device seconds {json.dumps(tr['range_device_s'])}\n")
    if device.type == "cuda":
        sys.stderr.write(f"portbench: card {power_limit()}\n")
    sys.stderr.write(
        f"portbench: setup {setup_s:.3f} s, window {win['window_s']:.3f} s,"
        f" requests {[round(r['wall'], 3) for r in win['records']]}, "
        f"capture copies {sum(s.seconds for s in sites.sites.values()):.3f}"
        f" s, outputs ok {outputs_ok}\n")
    res["check"] = check
    return res


def emit(res):
    for k, c in res["check"].items():
        sys.stderr.write(f"check {k} {c['value']!r} limit {c['limit']!r}\n")
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
