"""Remove every checkpoint of a work dir but the latest, optionally
pruning what is kept to inference weights (counterpart of
`tools/checkpoint_cleaner.py`, for the port's checkpoint layout).

- the trainer's step directories (`runner/trainer.py::CheckpointHook`:
  ``<workdir>/step_<n>/state.pt``): all but the highest step are removed;
  with ``--save-inf`` the kept one's optimiser states (keys ending in
  ``_opt`` or starting with ``opt_`` / ``optimizer``) are dropped and its
  floating tensors cast to ``--dtype``;
- flat ``.npz`` checkpoints, as the JAX tool treats them: all but the
  lexicographically-latest (or a ``latest.npz`` symlink target) are
  removed; with ``--save-inf`` those are instead pruned in place to
  inference weights (optimiser keys dropped, floats cast to ``--dtype``).

The reference strips ``optimizer`` and casts ``state_dict`` to fp16
(``tools/checkpoint_cleaner.py:16-27``).

  python -m mvedit_tpu_torch.tools.checkpoint_cleaner WORKDIR \\
      [--save-inf] [--dtype float16] [--yes]
"""
import argparse
import os
import re
import shutil
import sys

import numpy as np
import torch

__all__ = ["main", "save_inference", "save_inference_state"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Remove all checkpoints except the latest")
    p.add_argument("workdir", help="directory of checkpoints")
    p.add_argument("--save-inf", action="store_true",
                   help="drop optimiser states and cast floats: in the "
                        "kept step checkpoint, and in the non-latest npz "
                        "checkpoints instead of removing them")
    p.add_argument("--dtype", default="float16",
                   help="dtype of inference weights")
    p.add_argument("--yes", action="store_true",
                   help="skip the confirmation prompt")
    return p.parse_args(argv)


def _is_opt(key):
    return key.endswith("_opt") or key.startswith(("opt_", "optimizer"))


def save_inference(path, dtype):
    """A flat `.npz` checkpoint rewritten without optimiser keys, its
    floating arrays cast to `dtype` (as the JAX tool)."""
    d = dict(np.load(path, allow_pickle=True))
    opt_keys = [k for k in d if k.startswith(("opt_", "optimizer"))]
    if not opt_keys:
        print(f"Skipping {path} (no optimizer state)")
        return
    for k in opt_keys:
        del d[k]
    dt = np.dtype(dtype)
    for k, v in d.items():
        if isinstance(v, np.ndarray) and np.issubdtype(v.dtype,
                                                       np.floating):
            d[k] = v.astype(dt)
    np.savez(path, **d)
    print(f"Saved inference weights for {path}")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def save_inference_state(path, dtype):
    """A trainer checkpoint (`state.pt`) rewritten without its optimiser
    states, its floating tensors cast to `dtype`."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    opt_keys = [k for k in state if _is_opt(k)]
    if not opt_keys:
        print(f"Skipping {path} (no optimizer state)")
        return
    for k in opt_keys:
        del state[k]
    state = _cast(state, getattr(torch, dtype))
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    print(f"Saved inference weights for {path} (dropped {opt_keys})")


def main(argv=None):
    args = parse_args(argv)
    op = "prune" if args.save_inf else "remove"
    print(f"This will {op} all non-latest checkpoints in "
          f"{os.path.abspath(args.workdir)}")
    if not args.yes:
        ans = None
        while ans not in ("y", "n"):
            ans = input("continue? [y/n]")
        if ans == "n":
            sys.exit(0)

    for dirpath, dirnames, filenames in os.walk(args.workdir):
        step_dirs = {}
        for d in list(dirnames):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(dirpath, d, "state.pt")):
                step_dirs[int(m.group(1))] = d
        if step_dirs:
            latest = step_dirs[max(step_dirs)]
            for step, d in sorted(step_dirs.items()):
                if d == latest:
                    continue
                shutil.rmtree(os.path.join(dirpath, d))
                dirnames.remove(d)
                print(f"Removed {os.path.join(dirpath, d)}")
            if args.save_inf:
                save_inference_state(
                    os.path.join(dirpath, latest, "state.pt"), args.dtype)

        npzs = sorted(f for f in filenames if f.endswith(".npz"))
        if npzs:
            keep = "latest.npz" if "latest.npz" in npzs else npzs[-1]
            if os.path.islink(os.path.join(dirpath, keep)):
                tgt = os.path.basename(
                    os.path.realpath(os.path.join(dirpath, keep)))
                npzs = [f for f in npzs if f != tgt]
            npzs.remove(keep)
            for f in npzs:
                path = os.path.join(dirpath, f)
                if args.save_inf:
                    save_inference(path, args.dtype)
                else:
                    os.remove(path)
                    print(f"Removed {path}")


if __name__ == "__main__":
    main()
