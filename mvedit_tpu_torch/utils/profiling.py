"""Profiling hooks and phase timing of the MVEdit loop (counterpart of
`mvedit_tpu/utils/profiling.py`: `trace`, `annotate`, `PhaseTimer`,
`phase_timer`).

`trace(log_dir)` runs `torch.profiler` over its block and writes a Chrome
trace under `log_dir`; `annotate(name)` names a range inside it:

    with trace("traces"):
        with annotate("mesh_fit"):
            fit(...)

`MVEdit3DPipeline.__call__` ticks the installed timer after each phase
under the reference's names: `denoise_p1+vae_dec`, `nerf_fit`, `mesh_fit`,
`render_all`, `denoise_p2+vae_enc+solver` and `bake`. A tick waits for the
device (`torch.cuda.synchronize()` when any tensor it is given lives on a
GPU) and charges the host-clock time since the previous tick to its phase.

    from mvedit_tpu_torch.utils.profiling import PhaseTimer, set_phase_timer
    set_phase_timer(pt := PhaseTimer())
    runner.run_3d_to_3d(...)
    pt.report(), pt.steady("nerf_fit")
"""
import os
import statistics
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["trace", "annotate", "PhaseTimer", "set_phase_timer",
           "phase_timer"]


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
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    return False


class PhaseTimer:
    """Tick-based wall-clock accounting per phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.durations = defaultdict(list)   # per-tick wall times
        self.sigs = defaultdict(list)        # per-tick signatures
        self._last = None

    def mark(self):
        self._last = time.perf_counter()

    def tick(self, name, *tensors, sig=None):
        """Charge the time since the previous tick (or mark) to `name`,
        after the device has finished the work that produces `tensors`.
        `sig` (hashable) names the tick's configuration (render size, view
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


_PHASE_TIMER = None


def set_phase_timer(t):
    """Install (or clear, with None) the pipeline's phase timer."""
    global _PHASE_TIMER
    _PHASE_TIMER = t


def phase_timer():
    return _PHASE_TIMER
