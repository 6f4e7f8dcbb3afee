"""Preprocess KITTI-3D car instances into the ShapeNet-SRN layout of the
SSDNeRF datasets (counterpart of `tools/kitti_preproc.py`, host numpy and
PIL, the same output bytes).

The reference's `tools/kitti_preproc.py:80-165` without the mmcv
dependency: for every fully-visible, non-truncated car instance it crops
the instance mask, whitens the background, pads to a square sized by the
3D-bbox diagonal projection, resizes to ``--out-size`` (minus border), and
writes ``rgb/000000.png``, ``pose/000000.txt`` (OpenCV c2w normalized by
the bbox diagonal) and ``intrinsics.txt`` in SRN format.

  python -m mvedit_tpu_torch.tools.kitti_preproc --kitti-dir \
      data/kitti/training --out-dir data/shapenet/cars_kitti
"""
import argparse
import os
import os.path as osp

import numpy as np

__all__ = ["main"]


def yaw_to_rot_mat(yaw):
    sin_yaw, cos_yaw = np.sin(yaw), np.cos(yaw)
    rot = np.zeros(np.shape(yaw) + (3, 3), dtype=np.float32)
    rot[..., 0, 0] = cos_yaw
    rot[..., 2, 2] = cos_yaw
    rot[..., 0, 2] = sin_yaw
    rot[..., 2, 0] = -sin_yaw
    rot[..., 1, 1] = 1
    return rot


# KITTI camera (x right, y down, z fwd) -> object yaw frame conversion
ROT_CONVERSION = np.array([[0, 1, 0],
                           [0, 0, -1],
                           [-1, 0, 0]], dtype=np.float32)


def open_label_file(path):
    rows = []
    with open(path) as f:
        for line in f:
            v = line.strip().split(" ")
            rows.append([v[0]] + [float(x) for x in v[1:]])
    return rows


def open_calib_file(path, cam=2):
    assert 0 <= cam <= 3
    with open(path) as f:
        line = f.readlines()[cam]
    return np.array([float(v) for v in line.strip().split(" ")[1:]],
                    dtype=np.float32).reshape(3, 4)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Preprocess the KITTI dataset")
    p.add_argument("--kitti-dir", default="data/kitti/training")
    p.add_argument("--out-dir", default="data/shapenet/cars_kitti")
    p.add_argument("--out-size", type=int, default=128)
    p.add_argument("--out-border", type=int, default=4)
    return p.parse_args(argv)


def imresize(img, size):
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))


def main(argv=None):
    from PIL import Image

    args = parse_args(argv)
    image_dir = osp.join(args.kitti_dir, "image_2")
    seg_dir = osp.join(args.kitti_dir, "instance_2")
    label_dir = osp.join(args.kitti_dir, "label_2")
    calib_dir = osp.join(args.kitti_dir, "calib")
    resize_tgt = args.out_size - args.out_border * 2
    os.makedirs(args.out_dir, exist_ok=True)

    for label_file in sorted(os.listdir(label_dir)):
        basename = osp.splitext(label_file)[0]
        label = open_label_file(osp.join(label_dir, label_file))
        cali_mat = open_calib_file(osp.join(calib_dir, label_file))
        cam_k = cali_mat[:, :3]
        # camera translation from the projective calib column
        cam_t_vec = np.linalg.solve(cam_k, cali_mat[:, 3:]).squeeze(-1)
        image = np.asarray(Image.open(
            osp.join(image_dir, basename + ".png")).convert("RGB"))
        seg = np.asarray(Image.open(osp.join(seg_dir, basename + ".png")))
        for i, inst in enumerate(label):
            # truncated == 0 and occluded == 0 (fully visible) only
            if not (inst[1] == 0 and inst[2] == 0):
                continue
            mask = seg == i + 1000
            ys, xs = mask.nonzero()
            if len(ys) == 0:
                continue
            y0, y1 = ys.min(), ys.max() + 1
            x0, x1 = xs.min(), xs.max() + 1
            h, w = y1 - y0, x1 - x0
            img_crop_ori = image[y0:y1, x0:x1].copy()
            img_crop_ori[~mask[y0:y1, x0:x1]] = 255

            bbox_3d = np.array(inst[8:], dtype=np.float32)
            bbox_3d[[0, 1, 2]] = bbox_3d[[2, 0, 1]]   # hwl -> lhw
            diag = np.linalg.norm(bbox_3d[:3])
            bbox_3d[3:6] += cam_t_vec
            bbox_3d[4] -= bbox_3d[1] / 2              # box bottom -> center
            bbox_3d[:6] /= diag
            rot = yaw_to_rot_mat(bbox_3d[6]) @ ROT_CONVERSION
            c2w = np.concatenate(
                [rot.T, rot.T @ (-bbox_3d[3:6])[:, None]], axis=1)
            c2w = np.concatenate([c2w, [[0, 0, 0, 1]]], axis=0)

            # square pad sized by the projected bbox diagonal
            pad_tgt = max(int(round(np.linalg.norm(bbox_3d[:3])
                                    * cam_k[0, 0] / bbox_3d[5])),
                          max(h, w))
            scale = resize_tgt / pad_tgt
            if scale > 1:   # instance too small to supersample
                continue
            px_l = (pad_tgt - w) // 2
            px_r = pad_tgt - w - px_l
            py_t = (pad_tgt - h) // 2
            py_b = pad_tgt - h - py_t
            img = np.pad(img_crop_ori,
                         ((py_t, py_b), (px_l, px_r), (0, 0)),
                         constant_values=255)
            img = imresize(img, (resize_tgt, resize_tgt))
            img = np.pad(img, ((args.out_border,) * 2,
                               (args.out_border,) * 2, (0, 0)),
                         constant_values=255)

            inst_dir = osp.join(args.out_dir, f"{basename}_{i:03d}")
            os.makedirs(osp.join(inst_dir, "rgb"), exist_ok=True)
            os.makedirs(osp.join(inst_dir, "pose"), exist_ok=True)
            Image.fromarray(img).save(
                osp.join(inst_dir, "rgb", "000000.png"))
            Image.fromarray(img_crop_ori).save(
                osp.join(inst_dir, "000000.png"))
            np.savetxt(osp.join(inst_dir, "pose", "000000.txt"),
                       c2w.reshape(1, -1))
            fx = cam_k[0, 0] * scale
            cx = (cam_k[0, 2] - x0 + px_l) * scale + args.out_border
            cy = (cam_k[1, 2] - y0 + py_t) * scale + args.out_border
            with open(osp.join(inst_dir, "intrinsics.txt"), "w") as f:
                f.write(f"{fx:.6f} {cx:.6f} {cy:.6f} 0.\n0. 0. 0.\n1.\n"
                        f"{img.shape[0]} {img.shape[1]}\n")
            print(f"wrote {inst_dir}")


if __name__ == "__main__":
    main()
