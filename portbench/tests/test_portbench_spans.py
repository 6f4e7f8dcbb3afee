"""The reading of the program's own ranges (`harness/spans.py`) on
synthetic profiler events: a range's device time clipped to it, nested
ranges each counting what lies inside them, launches matched by thread and
correlation id, idle gaps named by the innermost program range; and
`Trace.read`'s own readings the same with the program's ranges in the
events as without them."""
import pytest
import torch

from portbench.harness.spans import SpanTrace, _Busy, program_gaps, \
    program_spans
from portbench.harness.trace import Trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, tid=1, corr=0, dev=CPU,
                 annotation=False):
        self._v = (name, start, end, tid, corr, dev, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _range(name, a, b, tid=1):
    return Event(name, a, b, tid=tid, annotation=True)


BENCH = [_range("portbench.request", 0, 1000),
         _range("portbench.render_all", 100, 400),
         _range("portbench.tick.nerf_fit", 95, 95)]
PROGRAM = [_range("mvedit.nerf_fit", 10, 95),
           _range("mvedit.render_all", 96, 450),
           _range("mvedit.bake", 500, 900),
           _range("mvedit.bake.texture", 600, 800)]
HOST = [Event("cudaLaunchKernel", 20, 22, corr=1),
        Event("cudaLaunchKernel", 150, 152, corr=2),
        Event("cudaLaunchKernel", 650, 652, corr=3),
        Event("cudaLaunchKernel", 700, 702, tid=2, corr=4),
        Event("cudaStreamSynchronize", 870, 875, corr=5),
        Event("aten::mm", 640, 660)]
DEVICE = [Event("k1", 30, 60, corr=1, dev=CUDA),
          Event("k2", 200, 300, corr=2, dev=CUDA),
          Event("k3", 660, 760, corr=3, dev=CUDA),
          Event("k4", 700, 720, corr=4, dev=CUDA),
          Event("Memcpy HtoD", 880, 950, corr=99, dev=CUDA),
          # a range's shadow on the device timeline
          Event("mvedit.bake", 500, 900, dev=CUDA, annotation=True)]


def _trace(cls, events):
    class Results:
        def events(self):
            return list(events)
    t = cls.__new__(cls)
    t.prof = type("P", (), {"profiler": type("Q", (), {
        "kineto_results": Results()})()})()
    t.t0, t.t1 = 0, 1000
    return t


def test_busy_is_the_union_clipped_to_the_window():
    b = _Busy([(0, 10), (5, 20), (30, 40), (40, 45), (60, 70)])
    assert b.within(0, 100) == 45
    assert b.within(8, 35) == 17
    assert b.within(20, 30) == 0
    assert b.within(42, 65) == 8
    assert b.within(33, 34) == 1
    assert _Busy([]).within(0, 10) == 0


def test_program_spans_clip_nest_and_match_launches():
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(),
               e.start_thread_id(), e.name()) for e in PROGRAM]
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
                for e in HOST if e.correlation_id()}
    device = [(e.start_ns(), min(e.start_ns() + e.duration_ns(), 1000),
               e.name(), e.correlation_id()) for e in DEVICE
              if not e.is_user_annotation()]
    got = program_spans(ranges, launches, device)
    want = {"mvedit.nerf_fit": (85, 30, 1), "mvedit.render_all": (354, 100, 1),
            # k3 and k4 overlap; the copy is clipped to the bake's end; k4
            # was launched on another thread, the copy matched no launch
            "mvedit.bake": (400, 120, 1), "mvedit.bake.texture": (200, 100, 1)}
    assert set(got) == set(want)
    for name, (host, busy, n) in want.items():
        r = got[name]
        assert r["count"] == 1 and r["launches"] == n, name
        assert r["host_s"] == pytest.approx(host * 1e-9), name
        assert r["busy_s"] == pytest.approx(busy * 1e-9), name
    gaps = program_gaps(ranges, device, 0, 1000, top=4)
    # named where each began and, where another, where it ended
    assert [n for n, _ in gaps] == [
        "render_all..bake.texture", "nerf_fit..render_all",
        "bake.texture..bake", "outside_spans"]
    assert [round(s * 1e9) for _, s in gaps] == [360, 140, 120, 50]


def test_trace_readings_ignore_the_program_ranges():
    plain = _trace(Trace, BENCH + HOST + DEVICE).read()
    both = _trace(Trace, BENCH + PROGRAM + HOST + DEVICE).read()
    assert plain == both
    assert plain["range_device_s"] == {"portbench.render_all":
                                       pytest.approx(100e-9)}
    assert plain["busy_s"] == pytest.approx(300e-9)
    spans = _trace(SpanTrace, BENCH + PROGRAM + HOST + DEVICE).read()
    assert {k: v for k, v in spans.items()
            if k not in ("program_spans", "program_gaps")} == plain
    assert spans["program_spans"]["mvedit.bake"]["launches"] == 1
    assert spans["program_gaps"][0][0] == "render_all..bake.texture"
