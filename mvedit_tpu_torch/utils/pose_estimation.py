"""Pose estimation from LoFTR matches (host-side scipy solvers).

Counterpart of `mvedit_tpu/utils/pose_estimation.py` (a copy: host code
the port may not import): the user's input image is matched against
generated views of known pose, and the epipolar residual -- the distance
between the two camera centres along the normal of the two matched rays
-- is minimised over

- `elev_estimation`: the elevation only (Zero123++ v1.1; azimuth 0, the
  distance the reference views' mean), dogbox + huber, bounds
  [-pi/2, pi/2];
- `pose5dof_estimation`: elevation, distance, focal, cx and cy (v1.2),
  with the reference's bounds and x_scale.
"""
import numpy as np
from scipy.optimize import least_squares

from .camera import get_pose_from_angles

__all__ = ["epipolar_residuals", "elev_estimation", "pose5dof_estimation"]


def _dirs_from_kpts(kpts, intrinsics):
    d = np.concatenate(
        [(kpts - intrinsics[2:]) / intrinsics[:2],
         np.ones((len(kpts), 1))], axis=-1)
    return d / np.clip(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8, None)


def _collect(matches, ref_poses, intrinsics):
    """matches: a list of (pts0, pts1, conf) per reference view, pixel
    coords at the `intrinsics` scale -> stacked (input dirs, reference
    dirs in world space, reference centres, sqrt(conf))."""
    in_dirs, ref_dirs_w, ref_pos_w, confs = [], [], [], []
    for (pts0, pts1, conf), pose in zip(matches, ref_poses):
        d0 = _dirs_from_kpts(pts0, intrinsics)
        d1 = _dirs_from_kpts(pts1, intrinsics)
        ref_dirs_w.append(d1 @ pose[:3, :3].T)
        ref_pos_w.append(np.tile(pose[:3, 3], (len(d1), 1)))
        in_dirs.append(d0)
        confs.append(conf)
    return (np.concatenate(in_dirs), np.concatenate(ref_dirs_w),
            np.concatenate(ref_pos_w),
            np.sqrt(np.concatenate(confs)))


def epipolar_residuals(in_dirs, pose, ref_dirs_w, ref_pos_w, sqrt_conf):
    in_dirs_w = in_dirs @ pose[:3, :3].T
    in_pos_w = pose[:3, 3][None]
    normals = np.cross(in_dirs_w, ref_dirs_w)
    normals /= np.clip(np.linalg.norm(normals, axis=-1, keepdims=True),
                       1e-8, None)
    d = np.sum((in_pos_w - ref_pos_w) * normals, axis=-1)
    return d * sqrt_conf * 100.0


def elev_estimation(matches, ref_poses, intrinsics):
    """Returns (elev_rad, pose (4, 4))."""
    in_dirs, ref_dirs_w, ref_pos_w, sc = _collect(matches, ref_poses,
                                                  intrinsics)
    distance = float(np.linalg.norm(
        np.asarray(ref_poses)[:, :3, 3], axis=-1).mean())

    def fun(elev):
        pose = get_pose_from_angles(np.array([0.0]), elev, distance)[0]
        return epipolar_residuals(in_dirs, pose, ref_dirs_w, ref_pos_w, sc)

    res = least_squares(fun, 0.0, method="dogbox", loss="huber",
                        bounds=[-np.pi / 2, np.pi / 2])
    elev = float(res.x[0])
    pose = get_pose_from_angles(np.array([0.0]), np.array([elev]),
                                distance)[0]
    return elev, pose


def pose5dof_estimation(matches_kpts, ref_poses, intrinsics,
                        intrinsics_size):
    """matches_kpts: a list of (pts0_raw, pts1, conf), pts0_raw the input
    image's pixels at `intrinsics_size` scale (its intrinsics are
    optimised). Returns (pose (4, 4), elev, distance, focal, cx, cy)."""
    _, ref_dirs_w, ref_pos_w, sc = _collect(
        [(p0, p1, c) for (p0, p1, c) in matches_kpts], ref_poses, intrinsics)
    in_kpts = np.concatenate([m[0] for m in matches_kpts])
    init_distance = float(np.linalg.norm(
        np.asarray(ref_poses)[:, :3, 3], axis=-1).mean())
    init_focal = float(intrinsics[0])

    def fun(params):
        elev, distance = params[:2]
        focal, cx, cy = params[2:]
        d0 = np.concatenate(
            [(in_kpts - np.array([cx, cy])) / focal,
             np.ones((len(in_kpts), 1))], axis=-1)
        d0 /= np.clip(np.linalg.norm(d0, axis=-1, keepdims=True), 1e-8, None)
        pose = get_pose_from_angles(np.array([0.0]), np.array([elev]),
                                    distance)[0]
        return epipolar_residuals(d0, pose, ref_dirs_w, ref_pos_w, sc)

    half = intrinsics_size / 2.0
    res = least_squares(
        fun, [0.0, init_distance, init_focal, half, half],
        method="dogbox", loss="huber",
        bounds=[[-np.pi / 2, 1.5, init_focal / 2, half - 50, half - 50],
                [np.pi / 2, 10, init_focal * 2, half + 50, half + 50]],
        x_scale=[1, 3, 200, 10, 10])
    elev, distance, focal, cx, cy = res.x
    pose = get_pose_from_angles(np.array([0.0]), np.array([elev]),
                                distance)[0]
    return pose, elev, distance, focal, cx, cy
