"""Generate and save a tetrahedral grid (counterpart of
`tools/generate_tets.py`).

The reference downloads quartet-generated grids (demo/tets/*.npz); this
writes the port's structured sphere-cropped grid (`models/mesh/dmtet.py::
build_grid_tets`) in the same npz layout (vertices, indices), so either
source works.

  python -m mvedit_tpu_torch.tools.generate_tets --resolution 128 \\
      [--out demo/tets/128_tets.npz]
"""
import argparse
import os

import numpy as np

__all__ = ["main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    from ..models.mesh.dmtet import build_grid_tets
    args = parse_args(argv)
    out = args.out or f"demo/tets/{args.resolution}_tets.npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    grid = build_grid_tets(args.resolution)
    np.savez_compressed(out, vertices=grid.verts, indices=grid.tets)
    print(f"wrote {out}: {len(grid.verts)} verts, {len(grid.tets)} tets, "
          f"{grid.num_edge_verts} unique edges")
    return out


if __name__ == "__main__":
    main()
