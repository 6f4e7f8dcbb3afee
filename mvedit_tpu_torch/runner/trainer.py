"""Training loop and hooks (counterpart of `mvedit_tpu/runner/trainer.py`).

- `Trainer`: an iteration loop calling `train_step(state, batch,
  generator) -> (state, metrics)`, then each hook's `after_iter`;
- `EmaHook`: an EMA of chosen state keys, its momentum ramped up over the
  first `rampup` steps (max(momentum, 1 / (1 + step)));
- `CheckpointHook`: `torch.save` of the state's tensors, moved to the CPU,
  under `step_N/state.pt` (with the EMA under "ema" when the trainer has an
  `EmaHook`), keeping the last `max_keep`; `load` returns (state, step);
- `LogHook` (`metrics.jsonl` and stdout), `EvalHook` (`eval.jsonl`) and
  `ModelUpdaterHook` (a function of the trainer at a given step).

A hook's work after an iteration is the span `hooks.<name>` (`ema`,
`checkpoint`, `log`, `eval`, `update`) of the installed phase timer.

State is a dict of trees of tensors (`models/ssdnerf.py::tree_map`).
"""
import json
import os
import shutil
import time
from typing import Callable, Dict, List

import torch

from ..models.ssdnerf import tree_map
from ..utils.profiling import span

__all__ = ["Hook", "EmaHook", "CheckpointHook", "LogHook",
           "ModelUpdaterHook", "EvalHook", "Trainer"]


class Hook:
    interval = 1

    def after_iter(self, trainer, metrics):
        pass

    def after_run(self, trainer):
        pass


class EmaHook(Hook):
    """EMA of the state's `keys`; the momentum ramps from 1 / (1 + step)
    down to `momentum` over the first `rampup` steps."""

    def __init__(self, keys=("denoiser", "decoder"), momentum=0.001,
                 rampup=1000, interval=1):
        self.keys = keys
        self.momentum = momentum
        self.rampup = rampup
        self.interval = interval
        self.ema = None

    def after_iter(self, trainer, metrics):
        if trainer.step % self.interval:
            return
        with span("hooks.ema"):
            self._update(trainer)

    def _update(self, trainer):
        src = {k: trainer.state[k] for k in self.keys}
        if self.ema is None:
            self.ema = tree_map(lambda x: x.detach().clone(), src)
            return
        m = max(self.momentum, 1.0 / (1.0 + trainer.step)) if self.rampup \
            and trainer.step < self.rampup else self.momentum
        with torch.no_grad():
            self.ema = tree_map(lambda e, s: e * (1 - m) + s * m,
                                self.ema, src)


def _steps(out_dir):
    return sorted(int(d.split("_")[1]) for d in os.listdir(out_dir)
                  if d.startswith("step_"))


class CheckpointHook(Hook):
    """The whole train state every `interval` steps and at the end of the
    run, the last `max_keep` kept."""

    def __init__(self, out_dir, interval=1000, max_keep=3):
        self.out_dir = out_dir
        self.interval = interval
        self.max_keep = max_keep
        os.makedirs(out_dir, exist_ok=True)

    def after_iter(self, trainer, metrics):
        if trainer.step % self.interval:
            return
        with span("hooks.checkpoint"):
            self.save(trainer)

    def after_run(self, trainer):
        # a short run still leaves a state to resume from
        if trainer.step % self.interval:
            self.save(trainer)

    def save(self, trainer):
        state = dict(trainer.state)
        ema = [h.ema for h in trainer.hooks
               if isinstance(h, EmaHook) and h.ema is not None]
        if ema:
            state["ema"] = ema[0]
        path = os.path.join(self.out_dir, f"step_{trainer.step}")
        os.makedirs(path, exist_ok=True)
        host = tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x)
                        else x, state)
        torch.save(host, os.path.join(path, "state.pt.tmp"))
        os.replace(os.path.join(path, "state.pt.tmp"),
                   os.path.join(path, "state.pt"))
        for s in _steps(self.out_dir)[: -self.max_keep]:
            shutil.rmtree(os.path.join(self.out_dir, f"step_{s}"),
                          ignore_errors=True)

    @staticmethod
    def load(out_dir, step=None, device=None):
        """(state with tensors on `device`, step), or (None, 0) when
        `out_dir` holds no checkpoint."""
        steps = _steps(out_dir) if os.path.isdir(out_dir) else []
        if not steps:
            return None, 0
        step = step or steps[-1]
        state = torch.load(os.path.join(out_dir, f"step_{step}", "state.pt"),
                           map_location=device, weights_only=True)
        return state, step


class LogHook(Hook):
    """metrics.jsonl and stdout every `interval` steps and at step 1."""

    def __init__(self, out_dir, interval=50):
        self.interval = interval
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._t0 = time.time()

    def after_iter(self, trainer, metrics):
        if trainer.step % self.interval and trainer.step != 1:
            return
        with span("hooks.log"):
            row = {"step": trainer.step,
                   "time": round(time.time() - self._t0, 2)}
            row.update({k: float(v) for k, v in metrics.items()})
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(f"[{trainer.step}] " + " ".join(
                f"{k}={v:.4g}" for k, v in row.items() if k != "step"))


class EvalHook(Hook):
    """eval_fn(state, step) -> dict of scalars, every `interval` steps and
    at the end of the run, appended to eval.jsonl."""

    def __init__(self, eval_fn, out_dir, interval=2000):
        self.eval_fn = eval_fn
        self.interval = interval
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "eval.jsonl")

    def after_iter(self, trainer, metrics):
        if trainer.step % self.interval:
            return
        with span("hooks.eval"):
            self._run(trainer)

    def after_run(self, trainer):
        self._run(trainer)

    def _run(self, trainer):
        out = {k: float(v)
               for k, v in self.eval_fn(trainer.state, trainer.step).items()}
        row = {"step": trainer.step, **out}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(f"[eval @{trainer.step}] " + " ".join(
            f"{k}={v:.4g}" for k, v in out.items()))


class ModelUpdaterHook(Hook):
    """schedule {step: fn(trainer)}: each fn once, after its step."""

    def __init__(self, schedule: Dict[int, Callable]):
        self.schedule = dict(schedule)

    def after_iter(self, trainer, metrics):
        fn = self.schedule.pop(trainer.step, None)
        if fn is not None:
            with span("hooks.update"):
                fn(trainer)


class Trainer:
    """Iteration-based trainer; the train step's draws come from
    `generator`."""

    def __init__(self, train_step, state, data_iter, hooks: List[Hook],
                 generator=None):
        self.train_step = train_step
        self.state = state
        self.data_iter = data_iter
        self.hooks = hooks
        self.step = 0
        self.generator = generator

    def run(self, max_iters):
        while self.step < max_iters:
            batch = next(self.data_iter)
            self.state, metrics = self.train_step(self.state, batch,
                                                  self.generator)
            self.step += 1
            for h in self.hooks:
                h.after_iter(self, metrics)
        for h in self.hooks:
            h.after_run(self)
        return self.state
