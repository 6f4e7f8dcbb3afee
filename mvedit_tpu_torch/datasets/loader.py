"""Batch iterators: scenes -> fixed-shape ray batches (counterpart of
`mvedit_tpu/datasets/loader.py`).

The draws are the reference's: numpy generators from the seed, so for one
seed both packages pick the same scenes, views and pixels. The rays are
computed on the host in float32 with the rounding of the reference's
`get_cam_rays` on the CPU, so that the batches equal the JAX package's bit
for bit:
- the pixel centres are `jnp.linspace(0.5, n - 0.5, n)` as XLA fuses it:
  0.5 * (1 - j * r) + j * c with r = f32(1 / (n - 1)), c = f32((n - 0.5) *
  r), the last multiply-add fused. Measured against JAX on the CPU: every
  centre at widths 8, 10, 16, 32, 64, 128, 256, 320, 400, 512, 800 and
  1024; at some other widths XLA fuses the first multiply-add instead for
  a few centres (111 of the 603351 centres of widths 2-1099 lie one ulp
  apart, and so do their rays);
- the camera-to-world rotation as XLA's dot rounds it, a chain of fused
  multiply-adds;
- the normalisation by its plain sum of squares.
A fused multiply-add is emulated exactly in float64: the product of two
float32 values is exact there, and so are the sums here. Only the sampled
pixels' rays are computed. `skip_iter` resumes the stream: the pixel draws
are keyed by the iteration index.
"""
import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["ray_batch_iterator", "scene_batch_iterator", "pixel_centres",
           "pixel_rays"]


def scene_batch_iterator(dataset, batch_size, seed=0, skip_iter=0,
                         shard=(0, 1)):
    """Yield lists of scene dicts, deterministic order, optionally sharded
    (host_id, num_hosts)."""
    rng = np.random.default_rng(seed)
    host, n_hosts = shard
    it = 0
    while True:
        order = rng.permutation(len(dataset))
        order = order[host::n_hosts]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            if it >= skip_iter:
                with span("loader.read"):
                    scenes = [dataset[j] for j in order[i:i + batch_size]]
                yield scenes
            it += 1


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def pixel_centres(j, n):
    """float32 pixel centres j + 0.5 of a width n, as the reference's
    `jnp.linspace(0.5, n - 0.5, n)[j]` rounds them (see the module doc)."""
    j = np.asarray(j)
    if n == 1:
        return np.full(j.shape, 0.5, np.float32)
    one = np.float32(1.0)
    r = one / np.float32(n - 1)
    c = np.float32(np.float32(n - 0.5) * r)
    jf = j.astype(np.float32)
    out = _fma(jf, c, np.float32(0.5) * (one - jf * r))
    return np.where(j == n - 1, np.float32(n - 0.5), out)


def pixel_rays(poses, intrinsics, vi, yi, xi, hw):
    """(rays_o, rays_d) (n, 3) float32 of pixels (vi, yi, xi): view vi's
    c2w `poses` (V, 3, 4) and [fx, fy, cx, cy] `intrinsics` (V, 4), pixel
    centres of an (h, w) = `hw` image, directions normalised; the bits of
    the JAX package's `get_cam_rays` on the CPU (`utils.geometry.
    get_cam_rays` gives the same rays of whole images within rounding)."""
    poses = np.asarray(poses, np.float32)[vi]
    intr = np.asarray(intrinsics, np.float32)[vi]
    dx = (pixel_centres(xi, hw[1]) - intr[:, 2]) / intr[:, 0]
    dy = (pixel_centres(yi, hw[0]) - intr[:, 3]) / intr[:, 1]
    rot = poses[:, :3, :3]
    d = np.stack([_fma(rot[:, i, 2], np.float32(1.0),
                       _fma(rot[:, i, 1], dy, rot[:, i, 0] * dx))
                  for i in range(3)], -1)
    ss = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    d = d * (np.float32(1.0) / np.sqrt(np.maximum(ss, np.float32(1e-12)))
             )[:, None]
    return poses[:, :3, 3].copy(), d


def ray_batch_iterator(dataset, batch_size, n_rays, seed=0, skip_iter=0,
                       shard=(0, 1), num_train_imgs=None, patch_size=None):
    """Yield dicts {rays_o, rays_d, rgb: (B, n_rays, 3) float32 CPU
    tensors, scene_ids, cond: None, captions}.

    num_train_imgs restricts the rays to the first k views of each scene;
    patch_size draws one contiguous (ps, ps) patch from one random view
    instead of n_rays scattered pixels (n_rays must equal ps * ps), the
    patches StableSSDNeRF's LPIPS term needs."""
    if patch_size is not None and n_rays != patch_size * patch_size:
        raise ValueError("patch mode needs n_rays == patch_size^2")
    it_idx = skip_iter
    for scenes in scene_batch_iterator(dataset, batch_size, seed, skip_iter,
                                       shard):
        rng = np.random.default_rng((seed + 1, it_idx))
        it_idx += 1
        with span("loader.rays"):
            batch = _ray_batch(scenes, rng, n_rays, num_train_imgs,
                               patch_size)
        yield batch


def _ray_batch(scenes, rng, n_rays, num_train_imgs, patch_size):
    """One batch of `ray_batch_iterator` from its scenes and the
    iteration's generator."""
    ro_b, rd_b, rgb_b, ids = [], [], [], []
    for s in scenes:
        imgs = s["images"]
        n, h, w = imgs.shape[:3]
        if num_train_imgs is not None:
            n = min(n, num_train_imgs)
        if patch_size is not None:
            ps = patch_size
            v = int(rng.integers(0, n))
            oy = int(rng.integers(0, max(h - ps, 0) + 1))
            ox = int(rng.integers(0, max(w - ps, 0) + 1))
            gy, gx = np.meshgrid(np.arange(oy, oy + ps),
                                 np.arange(ox, ox + ps), indexing="ij")
            vi = np.full(n_rays, v)
            yi = gy.reshape(-1)
            xi = gx.reshape(-1)
        else:
            vi = rng.integers(0, n, n_rays)
            yi = rng.integers(0, h, n_rays)
            xi = rng.integers(0, w, n_rays)
        o, d = pixel_rays(s["poses"], s["intrinsics"], vi, yi, xi, (h, w))
        ro_b.append(o)
        rd_b.append(d)
        rgb_b.append(imgs[vi, yi, xi])
        ids.append(s["scene_id"])
    return {
        "rays_o": torch.from_numpy(np.stack(ro_b)),
        "rays_d": torch.from_numpy(np.stack(rd_b)),
        "rgb": torch.from_numpy(np.stack(rgb_b)),
        "scene_ids": np.asarray(ids),
        "cond": None,
        "captions": [s.get("caption", "") for s in scenes],
    }
