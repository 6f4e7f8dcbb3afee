"""Loop `closed_requests`: one client, closed loop (the port serves one
request at a time, as `apis/server.py::ApiServer` does).

Request i takes the input `inputs[(o + i) % len(inputs)]` and the prompt
`prompts[(o + i) % len(prompts)]`, o drawn from the seed, so every seed
runs the same set of inputs in another order. Set-up makes every input of
the mix and runs one warm-up request with the mix's `warmup` arguments.
In the window, requests start back to back while fewer than `seconds`
have passed since it opened, and at least `min_requests` of them; the
request in flight then runs to its end and the window closes there.

A request's wall ends in `torch.cuda.synchronize()` with its output
written, less the host seconds the benchmark spent copying its captures.
The request itself is the configuration's `request(traffic, ctx)`: the
mix's `call` with `@name` arguments taken from `ctx` (`input`, `prompt`,
`seed`, `out_path` and the mix's `extra_inputs`).
"""
import os
import time
import traceback

import numpy as np
import torch

from portbench.harness.inputs import make_input

__all__ = ["Loop", "plan_requests"]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def plan_requests(traffic, seed, n):
    rng = np.random.default_rng(seed)
    inputs, prompts = traffic["inputs"], traffic["prompts"]
    o = int(rng.integers(len(inputs) * len(prompts)))
    return [dict(input=inputs[(o + i) % len(inputs)],
                 prompt=prompts[(o + i) % len(prompts)],
                 seed=int(seed) + i) for i in range(n)]


class Loop:
    def __init__(self, system, traffic, seed, workdir, device):
        self.system, self.traffic = system, traffic
        self.seed, self.workdir, self.device = seed, workdir, device
        self.cache, self.extra = {}, {}

    def _input(self, spec):
        """Inputs of a kind are made once per distinct spec (a file or an
        array), in set-up."""
        key = repr(sorted(spec.items()))
        if key not in self.cache:
            path = os.path.join(self.workdir, f"input_{len(self.cache)}.glb")
            self.cache[key] = make_input(spec, self.seed, path)
        return self.cache[key]

    def _ctx(self, req, out_path):
        return dict(self.extra, input=self._input(req["input"]),
                    prompt=req["prompt"], seed=req["seed"],
                    out_path=out_path)

    def setup(self):
        """Makes every input of the mix and runs the warm-up request."""
        for spec in self.traffic["inputs"]:
            self._input(spec)
        for k, v in self.traffic.get("extra_inputs", {}).items():
            self.extra[k] = make_input(v, self.seed, os.path.join(
                self.workdir, f"{k}.bin"))
        req = plan_requests(self.traffic, self.seed, 1)[0]
        self.system.request(self.traffic, self._ctx(req, os.path.join(
            self.workdir, "warmup.glb")), warmup=True)
        _sync(self.device)

    def run(self, seconds, hooks, begin, end):
        """Set-up, then the window between `begin()` and `end()`."""
        self.setup()
        begin()
        try:
            return self.window(seconds, hooks)
        finally:
            end()

    def window(self, seconds, hooks):
        """Runs the window; returns its records."""
        tr = self.traffic
        n_min = int(tr.get("min_requests", 1))
        plan = plan_requests(tr, self.seed, 10000)
        records, failed = [], 0
        t0 = time.perf_counter()
        i = 0
        while i < n_min or time.perf_counter() - t0 < seconds:
            ctx = self._ctx(plan[i], os.path.join(self.workdir,
                                                  f"out_{i}.glb"))
            ts = time.perf_counter()
            try:
                with hooks.request(i):
                    res = self.system.request(tr, ctx)
                    _sync(self.device)
                ok = bool(res.get("ok"))
            except Exception:
                traceback.print_exc()
                ok, res = False, {}
            cap = hooks.capture_seconds(i)
            wall = time.perf_counter() - ts - cap
            records.append(dict(wall=wall, capture_s=cap, ok=ok, **{
                k: v for k, v in res.items() if k != "ok"}))
            i += 1
            if not ok:
                failed += 1
                break
        window = time.perf_counter() - t0
        return dict(window_s=window, records=records, attempted=i,
                    failed=failed)
