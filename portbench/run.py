"""One run of one benchmark cell of `mvedit_tpu_torch` (the PyTorch / CUDA
port) on the machine it is started on.

    python portbench/run.py --workload mvedit_sd15.3d_to_3d --seed 7 \\
        --seconds 45 --trace 0

The cell, its configuration and its traffic mix are found by name through
`BENCHMARK.json` beside this folder: the configuration's sizes in
`portbench/configs/<config>.json` and its `build` in `<config>.py`, the
mix in `portbench/traffic/<traffic>.json`, each per-layer metric's reader
in `portbench/metrics/<metric>.py`. Set-up makes the weights and inputs
from `--seed` and warms the cell's shapes up; the window then runs the mix
for `--seconds`; the program's state is freed and the reference judges
what the window produced. The last line of standard output is the
result, one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.

`--trace 1` runs the window under `torch.profiler` and reports the
cell's per-layer metrics instead of its end-to-end ones. `--device cpu
--preset tiny` runs a cell at the configuration's tiny preset on the CPU,
for tests; `--control 1` puts the reference in a lower precision in the
program's place, and `--control 2` (training cells) the reference with
half of each batch left out, both of which the check has to refuse.
`--readings 1` also prints, before the compared numbers, what the control
reads on the same captures (`control <name> <value>`), so that one run
gives both readings a limit is set from.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# caches of the program's kernel builds stay in the checkout, at fixed paths
_CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(_CACHE, "torch_extensions"))
# libraries that would load JAX by themselves
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from portbench.harness import core  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="full", choices=("full", "tiny"))
    ap.add_argument("--control", type=int, choices=(0, 1, 2), default=0)
    ap.add_argument("--readings", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cell = core.load_cell(os.path.join(ROOT, "BENCHMARK.json"),
                          args.workload)
    if args.device == "cuda":
        core.require_cards(cell["chips"])
    device = torch.device(args.device)
    system = core.load_config_module(cell["config"]).build(
        cell["config_data"], args.seed, device, args.preset)
    workdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        res = core.run_cell(cell, system, args, device, workdir, T_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del system
    gc.collect()
    core.refuse_jax()
    core.emit(res)
    return res


if __name__ == "__main__":
    main()
