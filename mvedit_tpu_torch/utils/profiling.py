"""Profiling hooks and phase timing (counterpart of
`mvedit_tpu/utils/profiling.py`: `trace`, `annotate`, `PhaseTimer`,
`phase_timer`).

`trace(log_dir)` runs `torch.profiler` over its block and writes a Chrome
trace under `log_dir`; `annotate(name)` names a range inside it:

    with trace("traces"):
        with annotate("mesh_fit"):
            fit(...)

The program marks its work with two context managers that go through the
installed `PhaseTimer`:

- `phase(name, *tensors, sig=None)`, a timed phase: at its end it waits
  for the device (`torch.cuda.synchronize()` when any of `tensors`, which
  may be devices, is a GPU's) and charges the block's host-clock time to
  `name` (`PhaseTimer.tick`), so that it enters `report()`, `counts` and
  `steady()`;
- `span(name)`, a host-only range inside a phase or a request: it never
  waits and never enters `report()`.

With a timer installed both open `annotate(f"mvedit.{name}")`, a range
that the profiler stamps on the clock of the device's activity, and
record a `Span` in `timer.spans`. With none installed both give one
shared object that does nothing. Each endpoint call (`endpoint`) runs
inside a root `span("request")`; every span under it carries its
request id.

`count(name, n)` adds to a counter of the installed timer
(`PhaseTimer.counts`, beside the phases' ticks) and does nothing with
none installed.

`MVEdit3DPipeline.__call__`'s phases are the reference's: `denoise_p1+
vae_dec`, `nerf_fit`, `mesh_fit`, `render_all`, `denoise_p2+vae_enc+
solver` and `bake` (with the spans `bake.extract`, `bake.decimate`,
`bake.refine`, `bake.uv` and `bake.texture`); one step's phases follow
each other with no gap. `Zero123PlusPipeline.__call__`'s are `z123.cond`
(the vision tower and the condition's VAE encode), then per step
`z123.write`, `z123.controlnet` (the normal pass), `z123.read` and
`z123.solver`, and `z123.decode`; its counters are
`attention.kernel` and `attention.plain` (`dot_product_attention`'s calls
by path, on every caller; `attention.kernel.ragged` the kernel's calls
that only `kernel_takes` admits) and `z123.ref_bytes` (the stored
reference states' bytes).

    from mvedit_tpu_torch.utils.profiling import PhaseTimer, set_phase_timer
    set_phase_timer(pt := PhaseTimer())
    runner.run_3d_to_3d(...)
    pt.report(), pt.steady("nerf_fit"), pt.spans
"""
import functools
import os
import statistics
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["trace", "annotate", "PhaseTimer", "Span", "set_phase_timer",
           "phase_timer", "phase", "span", "count", "endpoint"]


@contextmanager
def trace(log_dir="traces"):
    """Profile the block with `torch.profiler` (the host always, the card
    where one is present) and write its Chrome trace to
    `log_dir/trace_<pid>_<n>.json`. Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    try:
        with prof:
            yield log_dir
    finally:
        n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name):
    """A named range in an active `trace` (`torch.profiler.
    record_function`); a context manager."""
    return torch.profiler.record_function(name)


def _on_cuda(x):
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, torch.device):
        return x.type == "cuda"
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    return False


class PhaseTimer:
    """Tick-based wall-clock accounting per phase, and the record of the
    phases and spans opened while it is installed (`spans`, unless
    `keep_spans` is False: a run of days keeps only the ticks)."""

    def __init__(self, keep_spans=True):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.durations = defaultdict(list)   # per-tick wall times
        self.sigs = defaultdict(list)        # per-tick signatures
        self.spans = [] if keep_spans else None
        self.requests = 0                    # root spans opened
        self._open = []                      # indices of open spans
        self._last = None

    def mark(self):
        self._last = time.perf_counter()

    def tick(self, name, *tensors, sig=None):
        """Charge the time since the previous tick (or mark) to `name`,
        after the device has finished the work that produces `tensors`
        (or the work queued on them, where they are devices). `sig`
        (hashable) names the tick's configuration (render size, view
        count...). A configuration's first tick on the card pays one-off
        costs that later ticks do not: kernel builds at first use, cuDNN's
        autotuning of a new convolution shape and the caching allocator's
        growth to the new peak; `steady` drops it."""
        if any(_on_cuda(t) for t in tensors):
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self._last is not None:
            d = now - self._last
            self.totals[name] += d
            self.counts[name] += 1
            self.durations[name].append(d)
            self.sigs[name].append(sig)
        self._last = now

    def steady(self, name, skip=1):
        """Median warm tick of `name` in seconds: each sig's first tick is
        dropped, or, when no tick carries a sig, the first `skip` ticks.
        None when no warm tick is left."""
        d = self.durations.get(name, [])
        s = self.sigs.get(name, [None] * len(d))
        if any(x is not None for x in s):
            seen, warm = set(), []
            for dur, sg in zip(d, s):
                if sg in seen:
                    warm.append(dur)
                else:
                    seen.add(sg)
        else:
            warm = d[skip:]
        return statistics.median(warm) if warm else None

    def report(self):
        """{phase: total seconds}, largest first."""
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))


class Span:
    """A phase or span: the context manager `phase` and `span` give with
    a timer installed, and its record in `timer.spans`: `name`;
    `parent`, the index in `spans` of the phase or span open when it
    began (None at a root); `request`, the id of its root; `start` and
    `end`, `time.perf_counter()` seconds (a phase's are its tick's, the
    device's wait included); `sig`, a phase's tick signature, which the
    block may set while it runs."""

    __slots__ = ("name", "parent", "request", "start", "end", "sig",
                 "_timer", "_tensors", "_range")

    def __init__(self, timer, name, tensors, sig):
        self.name, self.sig = name, sig
        self.parent = self.request = self.start = self.end = None
        self._timer, self._tensors = timer, tensors    # None: a span

    def __enter__(self):
        t = self._timer
        if t.spans is not None:
            if t._open:
                self.parent = t._open[-1]
                self.request = t.spans[self.parent].request
            else:
                t.requests += 1
                self.request = t.requests
            t._open.append(len(t.spans))
            t.spans.append(self)
        self._range = annotate(f"mvedit.{self.name}")
        self._range.__enter__()
        if self._tensors is None:
            self.start = time.perf_counter()
        else:
            t.mark()
            self.start = t._last
        return self

    def __exit__(self, *exc):
        t = self._timer
        try:
            if self._tensors is not None and exc[0] is None:
                t.tick(self.name, *self._tensors, sig=self.sig)
                self.end = t._last
            else:
                self.end = time.perf_counter()
        finally:
            self._range.__exit__(*exc)
            if t.spans is not None:
                t._open.pop()
            # the record keeps no tensor and no range alive
            self._timer = self._tensors = self._range = None
        return False


class _Off:
    """What `phase` and `span` give with no timer installed: one shared
    object that does nothing (a `sig` set on it is dropped)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setattr__(self, name, value):
        pass


_OFF = _Off()
_PHASE_TIMER = None


def set_phase_timer(t):
    """Install (or clear, with None) the pipeline's phase timer."""
    global _PHASE_TIMER
    _PHASE_TIMER = t


def phase_timer():
    return _PHASE_TIMER


def phase(name, *tensors, sig=None):
    """A timed phase of the installed timer (see the module doc)."""
    t = _PHASE_TIMER
    if t is None:
        return _OFF
    return Span(t, name, tensors, sig)


def span(name):
    """A host-only span of the installed timer (see the module doc)."""
    t = _PHASE_TIMER
    if t is None:
        return _OFF
    return Span(t, name, None, None)


def count(name, n=1):
    """Add `n` to the installed timer's `counts[name]` (a counter beside
    the phases' tick counts); nothing with no timer installed. `n` may be
    a function that gives it, called only with a timer installed."""
    t = _PHASE_TIMER
    if t is not None:
        t.counts[name] += n() if callable(n) else n


def endpoint(fn):
    """A runner's endpoint: with a timer installed, a call opens a root
    `span("request")`, and an endpoint that another one calls adds
    none."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        t = _PHASE_TIMER
        if t is None or t._open:
            return fn(*args, **kwargs)
        with Span(t, "request", None, None):
            return fn(*args, **kwargs)
    return call
