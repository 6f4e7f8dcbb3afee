"""Marching-tetrahedra lookup tables (from `mvedit_tpu/models/mesh/dmtet.py`).

Only the tables are ported so far: the structured grid
(`structured_tets.py`, the pipeline's default) derives its topology from
them. The unstructured `TetGrid` path (`build_grid_tets`, `marching_tets`,
`marching_tets_compact`) waits for its slice. The tables are the standard
public marching-tetrahedra tables (as in nvdiffrec).
"""
import numpy as np

__all__ = ["TRIANGLE_TABLE", "NUM_TRIANGLES_TABLE", "BASE_TET_EDGES"]

TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1]], np.int32)

NUM_TRIANGLES_TABLE = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int32)

BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3],
                          np.int32).reshape(6, 2)
