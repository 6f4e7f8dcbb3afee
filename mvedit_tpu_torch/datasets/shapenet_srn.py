"""ShapeNet SRN dataset (poses/intrinsics txt + per-view PNGs + captions);
a copy of `mvedit_tpu/datasets/shapenet_srn.py` (host numpy).

Rebuilds `lib/datasets/shapenet_srn.py:28` semantics: each scene directory
holds `rgb/*.png`, `pose/*.txt` (4x4 c2w, row-major), and `intrinsics.txt`
(focal cx cy on line 1, H W on line 3); optional captions pkl maps scene
name -> text. Returns numpy arrays; the training loader batches scenes.
"""
import os
import pickle

import numpy as np

__all__ = ["ShapeNetSRN"]


class ShapeNetSRN:
    def __init__(self, root, caption_path=None, num_views=None,
                 world_scale=1.0):
        self.root = root
        self.scenes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.num_views = num_views
        self.world_scale = world_scale
        self.captions = {}
        if caption_path and os.path.exists(caption_path):
            with open(caption_path, "rb") as f:
                self.captions = pickle.load(f)

    def __len__(self):
        return len(self.scenes)

    def scene_name(self, idx):
        return self.scenes[idx]

    def __getitem__(self, idx):
        from PIL import Image
        scene = os.path.join(self.root, self.scenes[idx])
        rgb_dir = os.path.join(scene, "rgb")
        pose_dir = os.path.join(scene, "pose")
        names = sorted(os.listdir(rgb_dir))
        if self.num_views is not None:
            names = names[: self.num_views]
        imgs, poses = [], []
        for n in names:
            imgs.append(np.asarray(
                Image.open(os.path.join(rgb_dir, n)).convert("RGB"),
                np.float32) / 255.0)
            p = np.loadtxt(os.path.join(
                pose_dir, n.rsplit(".", 1)[0] + ".txt")).reshape(4, 4)
            poses.append(p.astype(np.float32))
        with open(os.path.join(scene, "intrinsics.txt")) as f:
            vals = f.readline().split()
            focal, cx, cy = float(vals[0]), float(vals[1]), float(vals[2])
        poses = np.stack(poses)
        poses[:, :3, 3] *= self.world_scale
        h, w = imgs[0].shape[:2]
        intr = np.array([focal, focal, cx, cy], np.float32)
        return {
            "images": np.stack(imgs),
            "poses": poses[:, :3],
            "intrinsics": np.tile(intr, (len(imgs), 1)),
            "scene_id": idx,
            "scene_name": self.scenes[idx],
            "caption": self.captions.get(self.scenes[idx], ""),
            "hw": (h, w),
        }
