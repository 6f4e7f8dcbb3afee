"""Plain reference of the training loader's batches: every ray of a batch
traced back to the pixel it claims, from the dataset's own files.

For each scene of the batch (`scene_ids` index the scene folders in
sorted order), a ray's origin has to be one of the scene's camera
centres (`pose/*.txt`), its direction the normalised camera ray through
one pixel centre of that view (`intrinsics.txt`), its colour that
pixel of the view's PNG decoded with PIL and scaled by 1/255, and, in
patch mode, the rays of a scene one contiguous patch of one view in
row-major order; the batch's caption of a scene is the captions file's.

`loader_numbers` returns (the rays that fail any of these, the largest
gap between a ray's direction and its pixel's ray recomputed in
float64). With `control`, the batch's directions and colours rounded to
bfloat16 take the program's place.
"""
import os
import pickle

import numpy as np

__all__ = ["loader_numbers"]


def _bf16(x):
    """float32 -> bfloat16 -> float32, round to nearest even."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def loader_numbers(batch, root, captions_path, patch_size=None,
                   control=False):
    from PIL import Image
    scenes = sorted(d for d in os.listdir(root)
                    if os.path.isdir(os.path.join(root, d)))
    with open(captions_path, "rb") as f:
        captions = pickle.load(f)
    ro_b = np.asarray(batch["rays_o"], np.float32)
    rd_b = np.asarray(batch["rays_d"], np.float32)
    rgb_b = np.asarray(batch["rgb"], np.float32)
    if control:
        rd_b, rgb_b = _bf16(rd_b), _bf16(rgb_b)
    bad, worst = 0, 0.0
    for b, sid in enumerate(np.asarray(batch["scene_ids"]).tolist()):
        name = scenes[sid]
        d = os.path.join(root, name)
        names = sorted(os.listdir(os.path.join(d, "rgb")))
        poses = np.stack([np.loadtxt(os.path.join(
            d, "pose", n.rsplit(".", 1)[0] + ".txt")).reshape(4, 4)
            for n in names])
        with open(os.path.join(d, "intrinsics.txt")) as f:
            focal, cx, cy = (float(v) for v in f.readline().split()[:3])
        ro, rd, rgb = ro_b[b], rd_b[b], rgb_b[b]
        centres = poses[:, :3, 3].astype(np.float32)
        hit = (ro[:, None, :] == centres[None]).all(-1)            # (R, V)
        ok = hit.any(1)
        v = hit.argmax(1)
        # the pixel the direction points through, in the view's camera
        dc = np.einsum("rji,rj->ri", poses[v, :3, :3], rd.astype(np.float64))
        x = dc[:, 0] / dc[:, 2] * focal + cx - 0.5
        y = dc[:, 1] / dc[:, 2] * focal + cy - 0.5
        xi, yi = np.rint(x).astype(np.int64), np.rint(y).astype(np.int64)
        ok &= (dc[:, 2] > 0) & (np.abs(x - xi) < 1e-2) \
            & (np.abs(y - yi) < 1e-2)
        imgs = {}
        for vv in np.unique(v[ok]).tolist():
            imgs[vv] = np.asarray(Image.open(os.path.join(
                d, "rgb", names[vv])).convert("RGB"), np.float32) / 255.0
        h, w = next(iter(imgs.values())).shape[:2] if imgs else (0, 0)
        ok &= (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        for r in np.flatnonzero(ok):
            img = imgs[int(v[r])]
            ok[r] = bool((img[yi[r], xi[r]] == rgb[r]).all())
            pc = np.array([(xi[r] + 0.5 - cx) / focal,
                           (yi[r] + 0.5 - cy) / focal, 1.0])
            ref = poses[v[r], :3, :3] @ pc
            ref /= np.linalg.norm(ref)
            worst = max(worst, float(np.abs(rd[r] - ref).max()))
        if patch_size is not None and ok.all():
            ps = patch_size
            gy, gx = np.meshgrid(np.arange(ps), np.arange(ps),
                                 indexing="ij")
            ok &= (v == v[0]) & (yi == yi[0] + gy.reshape(-1)) \
                & (xi == xi[0] + gx.reshape(-1))
        if batch["captions"][b] != captions.get(name, ""):
            ok[:] = False
        bad += int((~ok).sum())
    return float(bad), worst
