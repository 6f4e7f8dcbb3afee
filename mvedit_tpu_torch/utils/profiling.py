"""Phase timing of the MVEdit loop (counterpart of
`mvedit_tpu/utils/profiling.py::PhaseTimer` / `phase_timer`).

`MVEdit3DPipeline.__call__` ticks the installed timer after each phase
under the reference's names: `denoise_p1+vae_dec`, `nerf_fit`, `mesh_fit`,
`render_all`, `denoise_p2+vae_enc+solver` and `bake`. A tick waits for the
device (`torch.cuda.synchronize()` when any tensor it is given lives on a
GPU) and charges the host-clock time since the previous tick to its phase.

    from mvedit_tpu_torch.utils.profiling import PhaseTimer, set_phase_timer
    set_phase_timer(pt := PhaseTimer())
    runner.run_3d_to_3d(...)
    pt.report()
"""
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimer", "set_phase_timer", "phase_timer"]


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
        `sig` names the tick's configuration (render size, view count...)
        for the reader of `durations` / `sigs`."""
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
