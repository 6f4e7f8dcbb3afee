"""Wrappers the benchmark puts around the program's entry points.

A `Site` replaces one attribute (a module function, or a method of a
model or of a class) by a wrapper, or with `Sites.add_function` every
binding of one function across the port's modules, and

- counts the calls of each request, in every scope it is given: all
  calls, or those made while another site's call is open (`"render_all"`
  counts the calls inside the pipeline's render-all);
- records each call's signature (the shapes and dtypes of its tensors,
  and its plain arguments) in the traced run, from which the metrics
  count work;
- in the request chosen for the check, copies one call of each scope to
  the host (its index drawn from the seed over the calls the previous
  request made in that scope): by default its inputs and its output, or
  what the site's `snap` takes before and after the call, for entries
  that work in place. The copy's host seconds, timed after the card's
  queue has drained, are kept per request, so that a request's wall can
  leave them out;
- opens a profiler range named `portbench.<site>` around the call when
  the run is traced, so that the kernels it launched can be found in the
  trace whatever implements them.

`restore()` puts every attribute back.
"""
import dataclasses
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

__all__ = ["Site", "Sites", "to_host", "to_device", "signature",
           "from_signature"]


def to_host(x):
    """A copy of a tree of tensors on the host; dataclasses become dicts of
    their plain fields."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name),
                              (int, float, str, bool, type(None)))}
    return x


def to_device(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x


def signature(x):
    """A hashable description of a call's arguments: tensors by shape and
    dtype, containers tagged by kind, plain values as they are, other
    objects by type name. `from_signature` makes meta tensors of it."""
    if torch.is_tensor(x):
        return ("T", tuple(x.shape), str(x.dtype))
    if isinstance(x, list):
        return ("L",) + tuple(signature(v) for v in x)
    if isinstance(x, tuple):
        return ("U",) + tuple(signature(v) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple(sorted((k, signature(v))
                                     for k, v in x.items()))
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    if isinstance(x, torch.dtype):
        return ("Y", str(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return signature(to_host(x))
    return ("O", type(x).__name__)


def from_signature(sig, dtype=torch.float32):
    """Arguments of the shapes a signature records, as float32 tensors on
    the `meta` device (integer tensors keep their dtype)."""
    if not isinstance(sig, tuple):
        return sig
    tag, rest = sig[0], sig[1:]
    if tag == "T":
        shape, dt = rest
        dt = getattr(torch, dt.split(".")[-1])
        return torch.empty(shape, dtype=dt if not dt.is_floating_point
                           else dtype, device="meta")
    if tag == "L":
        return [from_signature(v, dtype) for v in rest]
    if tag == "U":
        return tuple(from_signature(v, dtype) for v in rest)
    if tag == "D":
        return {k: from_signature(v, dtype) for k, v in rest}
    if tag == "Y":
        return getattr(torch, rest[0].split(".")[-1])
    return None


def _drain():
    """Waits for the card's queue, so that a capture's timed copy holds
    the copy alone and the request's own device work stays in its
    wall."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class CallSnap:
    """The default capture: a call's inputs and its output on the host."""

    @staticmethod
    def before(args, kwargs):
        return None

    @staticmethod
    def after(args, kwargs, out, pre):
        return (to_host(args), to_host(kwargs), to_host(out))


class Site:
    def __init__(self, name, owners, sites, capture=True, scopes=(None,),
                 snap=CallSnap):
        self.name, self.owners = name, owners
        self.capture, self.scopes, self.snap = capture, scopes, snap
        self.sites = sites
        owner, attr = owners[0]
        self.orig = getattr(owner, attr)
        self.had_own = [a in getattr(o, "__dict__", {}) for o, a in owners]
        self.depth = 0             # calls of this site open now
        self.counts = {}           # (request, scope) -> calls
        self.sigs = {}             # signature -> calls in the window
        self.captured = {}         # scope -> what `snap` took
        self.seconds = 0.0         # host time spent copying the captures
        orig = self.orig

        def wrapper(*args, **kwargs):
            s = self.sites
            r = s.request
            todo = []
            for scope in self.scopes:
                if scope is not None and s.sites[scope].depth == 0:
                    continue
                k = self.counts.get((r, scope), 0)
                self.counts[(r, scope)] = k + 1
                if self.capture and s.in_window and r == s.check_request \
                        and scope not in self.captured \
                        and k == s.pick(self, r, scope):
                    todo.append(scope)
            if s.in_window and s.tracing:
                sig = (signature(args), signature(kwargs))
                self.sigs[sig] = self.sigs.get(sig, 0) + 1
            pre = None
            if todo:
                _drain()
                t0 = time.perf_counter()
                pre = self.snap.before(args, kwargs)
                s.add_seconds(self, r, time.perf_counter() - t0)
            rng = (torch.profiler.record_function(f"portbench.{self.name}")
                   if s.tracing else nullcontext())
            self.depth += 1
            try:
                with rng:
                    out = orig(*args, **kwargs)
            finally:
                self.depth -= 1
            if todo:
                _drain()
                t0 = time.perf_counter()
                cap = self.snap.after(args, kwargs, out, pre)
                for scope in todo:
                    self.captured[scope] = cap
                s.add_seconds(self, r, time.perf_counter() - t0)
            return out
        self.wrapper = wrapper
        for o, a in owners:
            setattr(o, a, wrapper)

    def calls(self, r, scope=None):
        return self.counts.get((r, scope), 0)

    def restore(self):
        for (o, a), own in zip(self.owners, self.had_own):
            if own or not hasattr(type(o), a):
                setattr(o, a, self.orig)
            else:
                delattr(o, a)


class Sites:
    """The run's wrappers. `request` is the index of the request in
    flight (-1 for set-up), `in_window` whether the window is open; the
    signatures are recorded in the traced run."""

    def __init__(self, seed, tracing=False):
        self.sites = {}
        self.request = -1
        self.in_window = False
        self.tracing = tracing
        # the check judges calls of the window's second request, whose
        # draw of a call ranges over the calls the first one made
        self.check_request = 1
        self.rng = np.random.default_rng(seed)
        self.fractions = {}
        self.capture_s = {}        # request -> host seconds of captures

    def add(self, name, owner, attr, capture=True, scopes=(None,),
            snap=CallSnap):
        return self._add(name, [(owner, attr)], capture, scopes, snap)

    def add_function(self, name, func, capture=True, scopes=(None,),
                     snap=CallSnap, package="mvedit_tpu_torch"):
        """A site over every binding of `func` under its own name in the
        package's loaded modules (the module that defines it and those
        that imported it by name)."""
        attr = func.__name__
        owners = [(m, attr) for n, m in sorted(sys.modules.items())
                  if m is not None and (n == package
                                        or n.startswith(package + "."))
                  and getattr(m, attr, None) is func]
        return self._add(name, owners, capture, scopes, snap)

    def _add(self, name, owners, capture, scopes, snap):
        if name in self.sites:
            raise ValueError(f"site {name} twice")
        if not owners:
            raise ValueError(f"site {name}: nothing to wrap")
        self.sites[name] = Site(name, owners, self, capture, scopes, snap)
        for scope in scopes:
            self.fractions[(name, scope)] = float(self.rng.random())
        return self.sites[name]

    def pick(self, site, r, scope=None):
        """The call of request `r` to capture: drawn from the seed over the
        calls the previous request made in the scope."""
        n = site.calls(r - 1, scope)
        return int(self.fractions[(site.name, scope)] * n) if n else 0

    def add_seconds(self, site, r, dt):
        site.seconds += dt
        self.capture_s[r] = self.capture_s.get(r, 0.0) + dt

    def captures(self):
        """{site or site@scope: what was captured}, and under `"calls"`
        each site's calls in the check's request."""
        out = {}
        for n, s in self.sites.items():
            for scope, cap in s.captured.items():
                out[n if scope is None else f"{n}@{scope}"] = cap
        out["calls"] = {n: s.calls(self.check_request)
                        for n, s in self.sites.items()}
        return out

    def restore(self):
        for s in self.sites.values():
            s.restore()
