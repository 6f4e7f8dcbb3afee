"""NeRF-Synthetic (Blender) dataset: transforms_*.json + PNGs; a copy of
`mvedit_tpu/datasets/nerf_synthetic.py` (host numpy).

Rebuilds `lib/datasets/nerf_synthetic.py:36`: OpenGL c2w in the json are
converted to our OpenCV convention (flip y, z columns).
"""
import json
import os

import numpy as np

__all__ = ["NerfSynthetic"]


class NerfSynthetic:
    def __init__(self, root, split="train", white_background=True):
        self.root = root
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        self.frames = meta["frames"]
        self.camera_angle_x = meta["camera_angle_x"]
        self.white_background = white_background

    def __len__(self):
        return len(self.frames)

    def load_all(self):
        from PIL import Image
        imgs, poses = [], []
        for fr in self.frames:
            p = os.path.join(self.root, fr["file_path"] + ".png")
            im = np.asarray(Image.open(p), np.float32) / 255.0
            if im.shape[-1] == 4:
                a = im[..., 3:]
                rgb = im[..., :3]
                im = rgb * a + (1 - a) * (1.0 if self.white_background else 0)
            imgs.append(im)
            c2w = np.asarray(fr["transform_matrix"], np.float32)
            # OpenGL (-z fwd, y up) -> OpenCV (+z fwd, y down)
            c2w[:, 1:3] *= -1
            poses.append(c2w[:3])
        imgs = np.stack(imgs)
        h, w = imgs.shape[1:3]
        focal = 0.5 * w / np.tan(0.5 * self.camera_angle_x)
        intr = np.array([focal, focal, w / 2, h / 2], np.float32)
        return {"images": imgs, "poses": np.stack(poses),
                "intrinsics": np.tile(intr, (len(imgs), 1))}
