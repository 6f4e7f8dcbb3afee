"""Seeded triangle soups in pixel space that probe the raster selection's
edge cases, as numpy arrays: (pts (V, 3) float32 (u, v, z), faces (F, 3)
int64, face_valid (F,) bool, RasterConfig keywords). Shared by the CPU
tests of the selection's interface (`test_torch_raster_plan.py`), the
kernel's GPU tests (`test_torch_kernels_cuda.py`) and `chip_smoke.py`'s
kernel check. Both windings appear throughout.

- `slivers`: needles 2-8 tiles long and 1e-4 to 1 pixel wide over a
  background of small triangles (big list and bin lists).
- `pixel_grid`: a mesh whose vertices sit on pixel centres and on integer
  pixel edges, flat in z, so that edge tests tie at 0 on shared edges and
  neighbours tie on the key there (ties go to the lowest index).
- `duplicates`: every triangle three times, face 0 big (the big list's
  padding then repeats it as valid slots).
- `full_lists`: many tiny triangles in a small region, so the bin lists
  overflow and every slot is valid.
- `empty`: nothing covers any pixel (invalid, behind or off screen).
"""
import numpy as np


def _z(rng, n):
    return rng.uniform(1.0, 3.0, (n, 3, 1))


def _small(rng, n, lo, hi, ext=3.0):
    """n triangles of a few pixels with centres in [lo, hi)^2, (n, 3, 3)."""
    c = rng.uniform(lo, hi, (n, 1, 2))
    xy = c + rng.uniform(-ext, ext, (n, 3, 2))
    return np.concatenate([xy, _z(rng, n)], -1)


def _soup(tris, valid=None):
    tris = np.asarray(tris, np.float32)
    n = tris.shape[0]
    faces = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    valid = np.ones(n, bool) if valid is None else valid
    return tris.reshape(-1, 3), faces, valid


def slivers(seed, size):
    rng = np.random.default_rng(seed)
    n = 48
    a = rng.uniform(0, size, (n, 2))
    ang = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    perp = np.stack([-d[:, 1], d[:, 0]], -1)
    length = rng.uniform(32, 128, n)[:, None]
    width = 10.0 ** rng.uniform(-4, 0, n)[:, None]
    b = a + d * length
    c = a + d * length * rng.uniform(0, 1, (n, 1)) + perp * width
    needles = np.concatenate([np.stack([a, b, c], 1), _z(rng, n)], -1)
    tris = np.concatenate([_small(rng, 1500, 0, size), needles])
    return _soup(tris) + (dict(height=size, width=size, span=2,
                               k_per_tile=256, k_big=64),)


def pixel_grid(seed, size, step=3):
    rng = np.random.default_rng(seed)
    g = np.arange(0, size + step, step, dtype=np.float64)
    # columns alternate between pixel centres (+0.5) and integer edges
    off = np.where(np.arange(g.size) % 2 == 0, 0.5, 0.0)
    xs, ys = g + off, g + off[::-1]
    vx, vy = np.meshgrid(xs, ys)
    n = g.size
    v = np.stack([vx, vy, np.full_like(vx, 2.0)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00, v01 = i * n + j, i * n + j + 1
    v10, v11 = (i + 1) * n + j, (i + 1) * n + j + 1
    faces = np.concatenate([np.stack([v00, v01, v11], -1).reshape(-1, 3),
                            np.stack([v00, v11, v10], -1).reshape(-1, 3)])
    # shuffled, and half of them with the other winding
    faces = faces[rng.permutation(len(faces))]
    flip = rng.random(len(faces)) < 0.5
    faces[flip] = faces[flip][:, ::-1]
    return (v.astype(np.float32), faces.astype(np.int64),
            np.ones(len(faces), bool),
            dict(height=size, width=size, span=2, k_per_tile=256, k_big=64))


def duplicates(seed, size):
    rng = np.random.default_rng(seed)
    tris = _small(rng, 400, 0, size, ext=6.0)
    # face 0 is big: the big list's padding repeats it, valid
    big0 = np.array([[[0.1 * size, 0.1 * size, 2.5],
                      [0.9 * size, 0.2 * size, 2.5],
                      [0.4 * size, 0.9 * size, 2.5]]])
    bigs = np.concatenate([
        rng.uniform(0, size, (4, 3, 2)), _z(rng, 4)], -1)
    tris = np.concatenate([big0, bigs, tris, tris[::-1], tris])
    return _soup(tris) + (dict(height=size, width=size, span=2,
                               k_per_tile=256, k_big=64),)


def full_lists(seed, size):
    rng = np.random.default_rng(seed)
    tris = _small(rng, 6000, 0.3 * size, 0.6 * size, ext=2.0)
    return _soup(tris) + (dict(height=size, width=size, span=2,
                               k_per_tile=600, k_big=16),)


def empty(seed, size):
    rng = np.random.default_rng(seed)
    tris = _small(rng, 300, 0, size)
    tris[100:200, :, :2] += 4 * size          # off screen
    tris[200:, :, 2] = -1.0                   # behind the camera
    valid = np.ones(len(tris), bool)
    valid[:100] = False                       # masked
    return _soup(tris, valid) + (dict(height=size, width=size, span=2,
                                      k_per_tile=64, k_big=16),)


CASES = {"slivers": slivers, "pixel_grid": pixel_grid,
         "duplicates": duplicates, "full_lists": full_lists,
         "empty": empty}
