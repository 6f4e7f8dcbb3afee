"""The traced run's reading of the device: `torch.profiler` over the window,
read from its kineto events (no Chrome file is written).

- busy: the union of the kernel, memcpy and memset intervals inside the
  window (the arithmetic of the port's chip smoke's `read_trace` and
  `_union`, copied);
- per range: the device time of the kernels launched from inside each
  `portbench.<name>` site range (the innermost one open on the launching
  thread, however deep they nest), matched through the launch's
  correlation id; the device time launched outside every site range, and
  that matched to no launch, are reported beside them;
- the device operations that took the most time, and the longest idle
  gaps named by the benchmark's range that was open on the host when the
  gap began.

The profiler adds host time, so an idle share read here is an upper
bound.
"""
import bisect
import time
from collections import defaultdict

import torch

__all__ = ["Trace", "union", "innermost"]


def union(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def innermost(ranges, points):
    """{key: name of the innermost range holding t} for (t, key) points,
    over (start, end, name) ranges that nest (one thread's), however
    deep; points outside every range are left out."""
    out, stack = {}, []
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    j = 0
    for t, key in sorted(points):
        while j < len(rs) and rs[j][0] <= t:
            while stack and stack[-1][1] < rs[j][0]:
                stack.pop()
            stack.append(rs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


class Trace:
    """A context manager around the window; `mark(name)` leaves a named
    instant (a range of no length) on the host timeline."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    @staticmethod
    def mark(name):
        with torch.profiler.record_function(name):
            pass

    def read(self, top=10):
        """The window's readings, times in seconds."""
        t0, t1 = self.t0, self.t1
        ranges = defaultdict(list)          # name -> [(start, end, tid)]
        launches = {}                       # correlation -> (start, tid)
        device = []                         # (start, end, name)
        cpu = torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            # the host's operators, most of the events, first and cheaply
            if name.startswith("aten::"):
                continue
            if e.device_type() == cpu:
                if name.startswith("portbench."):
                    if e.is_user_annotation():
                        start = e.start_ns()
                        ranges[name].append((start, start + e.duration_ns(),
                                             e.start_thread_id()))
                elif name.startswith("cu"):
                    # a CUDA API call (`cudaLaunchKernel`, `cuLaunchKernelEx`,
                    # `cudaMemcpyAsync`...) with the correlation id of the
                    # device activity it started
                    corr = e.correlation_id()
                    if corr:
                        launches[corr] = (e.start_ns(), e.start_thread_id())
                continue
            # kernels, memcpys and memsets on the card (not the ranges'
            # shadows on the device timeline)
            if e.is_user_annotation():
                continue
            start = e.start_ns()
            if t0 <= start < t1:
                device.append((start, min(start + e.duration_ns(), t1),
                               name, e.correlation_id()))
        window = (t1 - t0) * 1e-9
        busy = union([(a, b) for a, b, _, _ in device]) * 1e-9
        # device time of the kernels launched inside each range: the
        # innermost site range open on the launching thread at the launch
        by_tid = defaultdict(list)
        for name, ivs in ranges.items():
            if name not in ("portbench.request", "portbench.window") \
                    and not name.startswith("portbench.tick."):
                for a, b, tid in ivs:
                    by_tid[tid].append((a, b, name))
        owner = {}                          # correlation -> range name
        for tid, ivs in by_tid.items():
            owner.update(innermost(ivs, [
                (t, corr) for corr, (t, ltid) in launches.items()
                if ltid == tid]))
        range_device = defaultdict(float)
        unmatched = unranged = 0.0
        for a, b, _, corr in device:
            if corr not in launches:
                unmatched += (b - a) * 1e-9
            elif corr in owner:
                range_device[owner[corr]] += (b - a) * 1e-9
            else:
                unranged += (b - a) * 1e-9
        ops = defaultdict(float)
        for a, b, name, _ in device:
            ops[name] += (b - a) * 1e-9
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = self._gaps(device, ranges, t0, t1, top)
        return dict(window_s=window, busy_s=busy, unmatched_s=unmatched,
                    unranged_s=unranged,
                    range_device_s=dict(range_device),
                    range_host_s={n: sum(b - a for a, b, _ in ivs) * 1e-9
                                  for n, ivs in ranges.items()
                                  if n.startswith("portbench.")},
                    device_ops=[[n, s] for n, s in top_ops],
                    idle_gaps=gaps,
                    marks={n: [a for a, _, _ in ivs]
                           for n, ivs in ranges.items()
                           if n.startswith("portbench.tick.")})

    @staticmethod
    def _gaps(device, ranges, t0, t1, top):
        """The longest idle gaps, each named by the innermost benchmark
        range open on the host when it began (or the phase whose tick
        closed it)."""
        ivs = sorted((a, b) for a, b, _, _ in device)
        gaps, end = [], t0
        for a, b in ivs:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if t1 > end:
            gaps.append((end, t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        spans = sorted((a, b, n) for n, v in ranges.items()
                       if n.startswith("portbench.")
                       and not n.startswith("portbench.tick.")
                       for a, b, _ in v)
        ticks = sorted((a, n[len("portbench.tick."):])
                       for n, v in ranges.items()
                       if n.startswith("portbench.tick.") for a, _, _ in v)
        tick_t = [a for a, _ in ticks]
        out = []
        for g0, g1 in gaps:
            name, best = "outside_ranges", None
            for a, b, n in spans:
                if a > g0:
                    break
                if b >= g0 and (best is None or a >= best):
                    name, best = n[len("portbench."):], a
            i = bisect.bisect_left(tick_t, g0)
            if i < len(ticks):
                name += f" in {ticks[i][1]}"
            out.append([name, (g1 - g0) * 1e-9])
        return out
