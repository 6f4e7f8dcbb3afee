"""`mvedit_tpu_torch/kernels/library.py`, the one place where a source of
`csrc/` becomes a bound library, on the CPU:

- each library's compiler argv: nvcc for sm_90a with `-fmad=false` for
  the raster selection, the segment sum and the dense grid (their bits
  are their plain versions', op by op) and without it for flash
  attention; g++ for the mesh library; and the `_build/` file names;
- the rebuild rule, through a stand-in compiler (it records each call,
  then runs g++) in a temporary directory: a missing library or one older
  than its source is built, a newer one is loaded as it is;
- a failed build raises `BuildError`, and again at the next `load()`
  without compiling again; a mesh library that does not build makes
  `native_available()` False.
"""
import ctypes
import dataclasses
import os
import sys

import numpy as np
import pytest

from mvedit_tpu_torch import native as TN
from mvedit_tpu_torch.kernels import dense_grid as KD
from mvedit_tpu_torch.kernels import flash_attention as FA
from mvedit_tpu_torch.kernels import library as L
from mvedit_tpu_torch.kernels import raster_select as RS
from mvedit_tpu_torch.kernels import segment_sum as SS

_CUDA = "/usr/local/cuda"
_NVCC = [f"{_CUDA}/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3"]
_NVCC_TAIL = ["-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the compilers' argv before `-o OUT SRC`, as each library was built
# before the library module held them
_ARGV = {
    "flash_attention": (FA, "flash_attention.cu", _NVCC + _NVCC_TAIL),
    "raster_select": (RS, "raster_select.cu",
                      _NVCC + ["-fmad=false"] + _NVCC_TAIL),
    "segment_sum": (SS, "segment_sum.cu",
                    _NVCC + ["-fmad=false"] + _NVCC_TAIL),
    "dense_grid": (KD, "dense_grid.cu",
                   _NVCC + ["-fmad=false"] + _NVCC_TAIL),
    "mesh_native": (TN, "mesh_native.cpp",
                    ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"]),
}


@pytest.mark.parametrize("name", sorted(_ARGV))
def test_each_library_builds_as_before(monkeypatch, name):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", _CUDA)
    mod, src, argv = _ARGV[name]
    lib = mod.LIBRARY
    src = os.path.join(L.SRC_DIR, src)
    assert os.path.exists(src)
    assert lib.argv("OUT") == argv + ["-o", "OUT", src]
    assert lib.path == os.path.join(L.BUILD_DIR, f"libmvedit_{name}.so")
    assert lib.log == os.path.join(L.BUILD_DIR,
                                   f"{name}.{argv[0].split('/')[-1]}.log")
    assert os.path.basename(L.BUILD_DIR) == "_build"
    assert os.path.dirname(L.BUILD_DIR) == os.path.dirname(L.SRC_DIR)


def _library(tmp_path, fails=False):
    """A library of one C entry, `mvedit_add`, built in `tmp_path` by a
    stand-in compiler that appends its argv to `calls.txt` and then runs
    g++ (or, with `fails`, exits 3)."""
    src = tmp_path / "add.cpp"
    if not src.exists():
        src.write_text('extern "C" int mvedit_add(int a, int b) '
                       '{ return a + b; }\n')
    stub = tmp_path / "stub.py"
    stub.write_text(
        "import subprocess, sys\n"
        f"with open({str(tmp_path / 'calls.txt')!r}, 'a') as f:\n"
        "    f.write(' '.join(sys.argv[1:]) + '\\n')\n"
        + ("sys.exit(3)\n" if fails else
           "sys.exit(subprocess.call(['g++'] + sys.argv[1:]))\n"))

    def bind(lib):
        lib.mvedit_add.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.mvedit_add.restype = ctypes.c_int
    return L.Library("add", str(src), [sys.executable, str(stub), "-O1",
                                       "-shared", "-fPIC"], bind,
                     build_dir=str(tmp_path / "_build"))


def _calls(tmp_path):
    path = tmp_path / "calls.txt"
    return len(path.read_text().splitlines()) if path.exists() else 0


@pytest.mark.parametrize("age", ["missing", "older", "newer"])
def test_a_library_is_rebuilt_when_missing_or_older_than_its_source(
        tmp_path, age):
    if age != "missing":
        first = _library(tmp_path)
        assert first.load().mvedit_add(2, 3) == 5
        assert _calls(tmp_path) == 1
        t = os.path.getmtime(first.path)
        os.utime(first.source,
                 (t + 10, t + 10) if age == "older" else (t - 10, t - 10))
    lib = _library(tmp_path)
    before = _calls(tmp_path)
    assert lib.load().mvedit_add(40, 2) == 42
    assert lib.load() is lib.load()
    assert _calls(tmp_path) - before == (0 if age == "newer" else 1)
    assert os.path.exists(lib.log)
    assert not [p for p in os.listdir(lib.build_dir) if p.endswith(".tmp")]


def test_a_failed_cuda_build_raises_and_is_not_repeated(tmp_path):
    stand_in = _library(tmp_path, fails=True)
    lib = dataclasses.replace(FA.LIBRARY, command=stand_in.command,
                              build_dir=stand_in.build_dir)
    for _ in range(2):
        with pytest.raises(L.BuildError, match="failed"):
            lib.load()
    assert _calls(tmp_path) == 1
    assert not os.path.exists(lib.path)


def test_a_failed_native_build_leaves_native_unavailable(tmp_path,
                                                         monkeypatch):
    stand_in = _library(tmp_path, fails=True)
    monkeypatch.setattr(TN, "LIBRARY", dataclasses.replace(
        TN.LIBRARY, command=stand_in.command,
        build_dir=stand_in.build_dir))
    assert not TN.native_available()
    assert not TN.native_available()
    assert _calls(tmp_path) == 1
    # welding takes the reference's numpy fallback; decimation raises
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1e-9, 0, 0]],
                 np.float32)
    f = np.array([[0, 1, 2], [3, 1, 2]], np.int32)
    v2, f2 = TN.weld_vertices(v, f)
    assert len(v2) == 3 and (f2[0] == f2[1]).all()
    with pytest.raises(RuntimeError, match="did not build"):
        TN.decimate_qem(v, f, 1)
