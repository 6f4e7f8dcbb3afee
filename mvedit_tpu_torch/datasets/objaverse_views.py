"""Objaverse rendered-views dataset from zip archives; a copy of
`mvedit_tpu/datasets/objaverse_views.py` (host numpy).

Rebuilds `lib/datasets/objaverse_views.py:51`: renders live inside per-scene
zips ({scene}/000.png + meta.json with per-view c2w/intrinsics); zips are
read lazily via ParallelZipFile (thread-safe); optional smart-crop + caption
table.
"""
import io
import json
import os

import numpy as np

from .parallel_zip import ParallelZipFile

__all__ = ["ObjaverseViews"]


class ObjaverseViews:
    def __init__(self, zip_dir, captions_json=None, num_views=None):
        self.zip_paths = sorted(
            os.path.join(zip_dir, f) for f in os.listdir(zip_dir)
            if f.endswith(".zip"))
        self.num_views = num_views
        self._zips = {}
        self.captions = {}
        if captions_json and os.path.exists(captions_json):
            with open(captions_json) as f:
                self.captions = json.load(f)

    def __len__(self):
        return len(self.zip_paths)

    def _zip(self, idx):
        if idx not in self._zips:
            self._zips[idx] = ParallelZipFile(self.zip_paths[idx])
        return self._zips[idx]

    def __getitem__(self, idx):
        from PIL import Image
        zf = self._zip(idx)
        names = sorted(n for n in zf.namelist() if n.endswith(".png"))
        if self.num_views:
            names = names[: self.num_views]
        meta_name = next(n for n in zf.namelist() if n.endswith("meta.json"))
        meta = json.loads(zf.read(meta_name))
        imgs = []
        for n in names:
            im = np.asarray(Image.open(io.BytesIO(zf.read(n))).convert(
                "RGBA"), np.float32) / 255.0
            rgb = im[..., :3] * im[..., 3:] + (1 - im[..., 3:])
            imgs.append(rgb)
        poses = np.asarray(meta["poses"], np.float32)[: len(imgs), :3]
        intr = np.asarray(meta["intrinsics"], np.float32)
        if intr.ndim == 1:
            intr = np.tile(intr, (len(imgs), 1))
        scene = os.path.basename(self.zip_paths[idx])[:-4]
        return {"images": np.stack(imgs), "poses": poses,
                "intrinsics": intr[: len(imgs)], "scene_id": idx,
                "scene_name": scene,
                "caption": self.captions.get(scene, "")}
