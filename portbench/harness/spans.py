"""The program's own ranges in a traced window. `mvedit_tpu_torch` opens a
`record_function` range `mvedit.<name>` for each of its phases and spans
while a phase timer is installed (`utils/profiling.py::phase`, `span`):
the pipeline's phases and the bake's parts in a request cell, the loader,
the step and their parts in a training cell.

- `program_spans`: for each `mvedit.*` name, its ranges' count, their host
  seconds, the device's busy seconds inside them (the union of the kernel,
  memcpy and memset intervals, clipped to each range) and the device
  operations launched from inside them on their own thread (matched by
  correlation id, as `Trace.read`'s `range_device_s` matches them), each
  range counting what happened inside it at any depth;
- `program_gaps`: the longest idle gaps, each named by the innermost
  `mvedit.*` range open when it began and, where another, the one open
  when it ended (`bake.texture..endpoint.init_mesh`);
- `SpanTrace`: `trace.Trace` with `read` returning both beside its own
  readings, which it leaves as they are.

The program's ranges are not entered into the attribution to the
benchmark's `portbench.*` ranges. Times are in nanoseconds in, seconds
out.
"""
import bisect
from collections import defaultdict

import torch

from .trace import Trace

__all__ = ["program_spans", "program_gaps", "SpanTrace", "PREFIX"]

PREFIX = "mvedit."


class _Busy:
    """The union of (start, end) intervals, integrated over any window in
    O(log n)."""

    def __init__(self, intervals):
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, a, b):
        # the intervals from the first ending past a to the last starting
        # before b
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        total = self.cum[j] - self.cum[i]
        total -= max(0, a - self.starts[i])
        total -= max(0, self.ends[j - 1] - b)
        return total


def program_spans(ranges, launches, device):
    """{name: {"count", "host_s", "busy_s", "launches"}} of the program's
    ranges.

    ranges: (start, end, thread, name) of the `mvedit.*` host ranges;
    launches: {correlation: (start, thread)} of the host's launch calls;
    device: (start, end, name, correlation) of the device's operations."""
    busy = _Busy([(a, b) for a, b, _, _ in device])
    launched = defaultdict(list)        # thread -> launch times of device ops
    for _, _, _, corr in device:
        if corr in launches:
            t, tid = launches[corr]
            launched[tid].append(t)
    for ts in launched.values():
        ts.sort()
    out = {}
    for a, b, tid, name in ranges:
        ts = launched.get(tid, ())
        r = out.setdefault(name, {"count": 0, "host_s": 0.0, "busy_s": 0.0,
                                  "launches": 0})
        r["count"] += 1
        r["host_s"] += (b - a) * 1e-9
        r["busy_s"] += busy.within(a, b) * 1e-9
        r["launches"] += bisect.bisect_right(ts, b) - bisect.bisect_left(
            ts, a)
    return out


def _innermost(spans, t):
    """The name of the innermost of the sorted (start, end, name) ranges
    holding t: the latest started of those open at t."""
    name = "outside_spans"
    for a, b, n in spans:
        if a > t:
            break
        if b >= t:
            name = n[len(PREFIX):]
    return name


def program_gaps(ranges, device, t0, t1, top=10):
    """The `top` longest idle gaps of the device in [t0, t1], as [name,
    seconds], each named by the innermost program range open on any thread
    when it began, and by the one open when it ended where that is
    another ("outside_spans" where none was)."""
    ivs = sorted((a, b) for a, b, _, _ in device)
    gaps, end = [], t0
    for a, b in ivs:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    spans = sorted((a, b, n) for a, b, _, n in ranges)
    out = []
    for g0, g1 in gaps:
        began, ended = _innermost(spans, g0), _innermost(spans, g1)
        name = began if began == ended else f"{began}..{ended}"
        out.append([name, (g1 - g0) * 1e-9])
    return out


class SpanTrace(Trace):
    """`Trace` whose `read` adds `program_spans` and `program_gaps`."""

    def read(self, top=10):
        res = super().read(top)
        t0, t1 = self.t0, self.t1
        ranges, launches, device = [], {}, []
        cpu = torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith("aten::"):
                continue
            if e.device_type() == cpu:
                if name.startswith(PREFIX) and e.is_user_annotation():
                    a = e.start_ns()
                    ranges.append((a, a + e.duration_ns(),
                                   e.start_thread_id(), name))
                elif name.startswith("cu") and e.correlation_id():
                    launches[e.correlation_id()] = (e.start_ns(),
                                                    e.start_thread_id())
                continue
            if e.is_user_annotation():
                continue
            a = e.start_ns()
            if t0 <= a < t1:
                device.append((a, min(a + e.duration_ns(), t1), name,
                               e.correlation_id()))
        res["program_spans"] = program_spans(ranges, launches, device)
        res["program_gaps"] = program_gaps(ranges, device, t0, t1, top)
        return res
