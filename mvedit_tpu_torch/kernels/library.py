"""How a hand-written source under `csrc/` becomes a bound library, and how
its C entries are launched: the one place of both for every kernel
wrapper and for `native`.

A `Library` names its source, states its build command once where it is
declared (`nvcc(*flags)` for a CUDA source, with the library's own flags;
g++ for the host library) and binds its C entries' `argtypes` and
`restype` in its `bind(lib)`. `load()` builds the library into
`_build/libmvedit_<name>.so` when it is missing or older than its source,
then loads and binds it once a process. The compiler writes a temporary
file, renamed into place only when it succeeded, and a lock makes the
process's threads build once. A failed build raises `BuildError` with
the compiler's output; a failed build or load raises the same error again
on every later `load()` without building again. The compiler's report
(ptxas': registers, shared memory and spills per instantiation) goes to
`_build/<name>.<compiler>.log`.

`on_stream(dev, fn, *args)` calls a C entry with the current stream of
CUDA device `dev` as its last argument.
"""
import ctypes
import dataclasses
import os
import subprocess
import threading
from typing import Callable, Optional

import torch

__all__ = ["Library", "BuildError", "nvcc", "on_stream", "SRC_DIR",
           "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


class BuildError(RuntimeError):
    """A library's compiler failed, timed out or was not found."""


def nvcc(*flags):
    """The nvcc command for sm_90a (before `-o OUT SRC`), with a library's
    own `flags` after `-O3`."""
    return ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", *flags, "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas=-v"]


def _compiler(name):
    """The program a command names: nvcc from the CUDA toolkit that
    PyTorch finds, any other as named."""
    if name != "nvcc":
        return name
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise BuildError("no CUDA toolkit found for nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@dataclasses.dataclass
class Library:
    """A shared library built from `source` (a file of `csrc/`, or an
    absolute path) by `command` (the compiler, then its flags; `-o OUT
    SRC` are appended) into `build_dir`, its entries declared by `bind`.
    `timeout` bounds the compiler's seconds (None: no bound)."""
    name: str
    source: str
    command: list
    bind: Callable
    timeout: Optional[float] = None
    build_dir: str = BUILD_DIR
    _lib: object = dataclasses.field(default=None, init=False, repr=False)
    _error: object = dataclasses.field(default=None, init=False, repr=False)
    _lock: object = dataclasses.field(default_factory=threading.Lock,
                                      init=False, repr=False)

    def __post_init__(self):
        self.source = os.path.join(SRC_DIR, self.source)

    @property
    def path(self):
        return os.path.join(self.build_dir, f"libmvedit_{self.name}.so")

    @property
    def log(self):
        return os.path.join(self.build_dir, f"{self.name}."
                            f"{os.path.basename(self.command[0])}.log")

    def argv(self, out):
        """The compiler's argv that writes the library to `out`."""
        return [_compiler(self.command[0]), *self.command[1:], "-o", out,
                self.source]

    def _build(self):
        """Compile the source when the library is missing or older than
        it: to a temporary file, renamed into place on success."""
        if os.path.exists(self.path) and os.path.getmtime(
                self.path) >= os.path.getmtime(self.source):
            return
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(self.argv(tmp), capture_output=True,
                                 text=True, timeout=self.timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise BuildError(f"building {self.source} failed: {e}") from e
        if res.returncode != 0:
            raise BuildError(f"{self.command[0]} failed for {self.source} "
                             f"({res.returncode}):\n{res.stdout}\n"
                             f"{res.stderr}")
        with open(self.log, "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, self.path)

    def load(self):
        """The bound ctypes library, built first where needed; raises
        `BuildError` or `OSError` when it cannot be built or loaded."""
        if self._lib is None:
            with self._lock:
                if self._error is not None:
                    raise self._error.with_traceback(None)
                if self._lib is None:
                    try:
                        self._build()
                        lib = ctypes.CDLL(self.path)
                    except (BuildError, OSError) as e:
                        self._error = e
                        raise
                    self.bind(lib)
                    self._lib = lib
        return self._lib


def on_stream(dev, fn, *args):
    """`fn(*args, stream)`: the C entry called with the current stream of
    CUDA device `dev`. The entries launch on the runtime's current device,
    so `dev`'s context is entered only when it is another."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)
