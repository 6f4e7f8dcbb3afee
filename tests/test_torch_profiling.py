"""The port's phase timer as a span recorder (`mvedit_tpu_torch/utils/
profiling.py`), on the CPU:

- with no timer installed, `phase` and `span` give one shared object that
  records nothing, opens no profiler range and waits for no device, and an
  endpoint runs as it is;
- a request's spans: each endpoint call opens a root `request` span whose
  id every span under it carries, parents as the blocks nest, an endpoint
  called from another adds no request;
- `report()`, `counts`, `durations` and `steady()` read from `phase`
  blocks as from the `mark` / `tick` pairs they replace, on one clock;
- a subclass's `tick` still fires at the end of a phase;
- a phase's and a span's ranges in `trace()`'s Chrome file, under their
  `mvedit.` names.
"""
import itertools
import json
import os
import types

import pytest
import torch

from mvedit_tpu_torch.utils import profiling as P


@pytest.fixture
def timer():
    t = P.PhaseTimer()
    P.set_phase_timer(t)
    try:
        yield t
    finally:
        P.set_phase_timer(None)


@pytest.fixture
def clock(monkeypatch):
    """The module's `time.perf_counter()` reads 0, 1, 2, ... in turn."""
    monkeypatch.setattr(P, "time", types.SimpleNamespace(
        perf_counter=itertools.count().__next__))


def _refuse(*a, **k):
    raise AssertionError("called with no timer installed")


def test_no_timer_costs_nothing(monkeypatch):
    monkeypatch.setattr(P, "annotate", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(P, "time", None)
    assert P.phase_timer() is None
    off = P.phase("nerf_fit", torch.device("cuda"), sig=(1,))
    assert off is P.span("bake.uv") is P.phase("bake")
    with P.phase("render_all", torch.device("cuda")) as ph:
        ph.sig = (True, 64, 3)
        with P.span("bake.texture"):
            pass
    assert not hasattr(off, "sig")

    @P.endpoint
    def run(x):
        return x + 1
    assert run(1) == 2 and run.__name__ == "run"


def test_request_ids_and_parents(timer):
    @P.endpoint
    def inner():
        with P.phase("code_sample"):
            pass

    @P.endpoint
    def outer():
        with P.span("endpoint.preproc"):
            pass
        inner()
        with P.phase("bake"):
            with P.span("bake.extract"):
                pass
            with P.span("bake.uv"):
                pass
    outer()
    outer()
    with P.phase("loader"):
        with P.span("loader.read"):
            pass
    got = [(s.name, s.parent, s.request) for s in timer.spans]
    first = [("request", None, 1), ("endpoint.preproc", 0, 1),
             ("code_sample", 0, 1), ("bake", 0, 1), ("bake.extract", 3, 1),
             ("bake.uv", 3, 1)]
    second = [(n, None if p is None else p + 6, 2) for n, p, _ in first]
    assert got == first + second + [("loader", None, 3),
                                    ("loader.read", 12, 3)]
    assert timer.requests == 3 and not timer._open
    for s in timer.spans:
        assert s.start <= s.end
        assert s._timer is s._tensors is s._range is None
        if s.parent is not None:
            par = timer.spans[s.parent]
            assert par.start <= s.start and s.end <= par.end
    # the spans stay out of the phases' accounting
    assert set(timer.report()) == {"code_sample", "bake", "loader"}
    assert timer.counts["bake"] == 2


def test_phases_read_as_ticks(clock):
    """One clock, two timers: `phase` blocks and the `mark` / `tick` pairs
    they replace give the same totals, counts, durations, sigs and warm
    medians; a span between the phases is charged to none of them."""
    blocks = P.PhaseTimer()
    P.set_phase_timer(blocks)
    try:
        with P.phase("a", sig=1):
            pass
        with P.phase("b") as ph:
            with P.span("b.part"):
                pass
            ph.sig = "late"
        with P.span("between"):
            pass
        with P.phase("a", sig=1):
            pass
        with P.phase("a", sig=2):
            pass
    finally:
        P.set_phase_timer(None)
    ticks = P.PhaseTimer()
    # the same reads of the clock as the blocks made: 0..1 a, 2..5 b (its
    # span took 3 and 4), the span 6..7, then a twice
    for t0, name, sig in ((0, "a", 1), (2, "b", "late"), (8, "a", 1),
                          (10, "a", 2)):
        P.time.perf_counter = itertools.count(t0).__next__
        ticks.mark()
        if name == "b":
            P.time.perf_counter = itertools.count(5).__next__
        ticks.tick(name, sig=sig)
    for k in ("totals", "counts", "durations", "sigs"):
        assert getattr(blocks, k) == getattr(ticks, k), k
    assert blocks.report() == ticks.report() == {"a": 3, "b": 3}
    assert blocks.steady("a") == ticks.steady("a") == 1.0
    assert [(s.name, s.start, s.end, s.sig) for s in blocks.spans] == [
        ("a", 0, 1, 1), ("b", 2, 5, "late"), ("b.part", 3, 4, None),
        ("between", 6, 7, None), ("a", 8, 9, 1), ("a", 10, 11, 2)]


def test_phase_without_keeping_spans_and_on_error(clock):
    t = P.PhaseTimer(keep_spans=False)
    P.set_phase_timer(t)
    try:
        with P.phase("step"):
            with P.span("step.update"):
                pass
        with pytest.raises(ValueError):
            with P.phase("step"):
                raise ValueError
    finally:
        P.set_phase_timer(None)
    # the failed block is charged to nothing
    assert t.spans is None and t.durations["step"] == [3.0]


def test_subclass_tick_fires(timer, monkeypatch):
    seen = []

    class Marked(P.PhaseTimer):
        def tick(self, name, *tensors, sig=None):
            super().tick(name, *tensors, sig=sig)
            seen.append((name, sig))
    t = Marked()
    P.set_phase_timer(t)
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: waits.append(1))
    with P.phase("nerf_fit", torch.device("cpu"), sig=(64, 2)):
        with P.span("fit.inner"):
            pass
    with P.phase("render_all", torch.device("cuda")):
        pass
    assert seen == [("nerf_fit", (64, 2)), ("render_all", None)]
    assert waits == [1] and t.counts["nerf_fit"] == 1


def test_ranges_in_the_chrome_trace(timer, tmp_path):
    d = str(tmp_path / "trace")
    with P.trace(d):
        with P.phase("mesh_fit", torch.zeros(2)):
            with P.span("bake.uv"):
                torch.ones(4).sum()
    (f,) = os.listdir(d)
    with open(os.path.join(d, f)) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"mvedit.mesh_fit", "mvedit.bake.uv"} <= names
    assert timer.counts["mesh_fit"] == 1
