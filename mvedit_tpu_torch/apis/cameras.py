"""Camera rig constants for every endpoint (domain constants to preserve).

Values from `lib/apis/adapter3d.py:119-155,425-454,790-800,884-892` — these
rigs define output geometry and must match the reference exactly.
A numpy-only copy of `mvedit_tpu/apis/cameras.py`.
"""
import math

import numpy as np

from ..utils.camera import get_pose_from_angles, random_surround_views

__all__ = ["zero123plus_v11_rig", "zero123plus_v12_rig",
           "superres_cameras", "surround_rig", "CONSTANTS"]

CONSTANTS = dict(
    zero123plus_pad_ratio=0.75,
    zero123plus1_2_pad_ratio=0.9,
    zero123plus_crop_ratio=0.9,
    superres_camera_distance=3.1,
    superres_min_elev=0.0,
    superres_max_elev=0.4,
    superres_fov=40,
    superres_num_cameras=6,
    preproc_num_views=12,
    preproc_render_size=256,
    proc_3d_to_3d_fov=30,
    proc_3d_to_3d_camera_distance=3.7,
    proc_3d_to_3d_min_elev=-0.3,
    proc_3d_to_3d_max_elev=0.6,
    proc_3d_to_3d_tex_min_elev=-0.1,
    proc_3d_to_3d_tex_max_elev=0.3,
    proc_retex_min_elev=-0.1,
    proc_retex_max_elev=0.5,
    ssdnerf_camera_distance=2.8,
    ssdnerf_min_elev=0.0,
    ssdnerf_max_elev=0.6,
    ssdnerf_fov=40,
    ssdnerf_render_size=160,
    ssdnerf_front_azi=math.pi / 2,
    # per-view camera weights for zero123plus_to_mesh (adapter3d.py:820)
    zero123plus_cam_weights=[3.0] + [1.5, 0.95, 0.93, 0.88, 1.0, 1.45] * 6,
    # v1.2 rig weights (adapter3d.py:918 run_zero123plus1_2_to_mesh)
    zero123plus1_2_cam_weights=[2.0] + [1.1, 0.95, 0.9, 0.85, 1.0, 1.05] * 6,
    vonmises_kappa=0.3,
)


def zero123plus_v11_rig():
    """36-view rig for v1.1: 6 views x (3 orig + 3 mirrored) passes
    (adapter3d.py:790-800). Returns (poses (36,4,4), fov_deg, distance)."""
    crop_half = int(round(160 * CONSTANTS["zero123plus_crop_ratio"]))
    focal = 350.0
    fov = np.rad2deg(np.arctan(crop_half / focal) * 2)
    distance = 1.0 / np.sin(np.radians(fov / 2))
    azims = np.array([30, 90, 150, 210, 270, 330,
                      330, 270, 210, 150, 90, 30] * 3, np.float32)
    elevs = np.array([30, -20] * 18, np.float32)
    poses = get_pose_from_angles(np.radians(azims), np.radians(elevs),
                                 distance)
    return poses, float(fov), float(distance)


def zero123plus_v12_rig():
    """v1.2 rig (adapter3d.py:884-892)."""
    fov = 30.0
    distance = 1.0 / np.sin(np.radians(fov / 2))
    azims = np.array([30, 90, 150, 210, 270, 330,
                      330, 270, 210, 150, 90, 30] * 3, np.float32)
    elevs = np.array([20, -10] * 18, np.float32)
    poses = get_pose_from_angles(np.radians(azims), np.radians(elevs),
                                 distance)
    return poses, fov, float(distance)


def superres_cameras(camera_distance=None, fov=None, num_cameras=None,
                     min_elev=None, max_elev=None, begin_rad=0.0,
                     ref_pose=None, rng=None):
    """6 linspace surround views + 2 polar regularization poses
    (adapter3d.py:430-454). The elevations are drawn from `rng` (the
    reference draws them from an unseeded generator)."""
    c = CONSTANTS
    camera_distance = camera_distance or c["superres_camera_distance"]
    fov = fov or c["superres_fov"]
    num_cameras = num_cameras or c["superres_num_cameras"]
    min_elev = c["superres_min_elev"] if min_elev is None else min_elev
    max_elev = c["superres_max_elev"] if max_elev is None else max_elev
    poses = random_surround_views(
        camera_distance, num_cameras, min_elev, max_elev,
        use_linspace=True, begin_rad=begin_rad, rng=rng)[:, :3]
    if ref_pose is not None:
        poses[0] = ref_pose
    focal = 512 / (2 * np.tan(np.radians(fov / 2)))
    intr = np.tile(np.array([focal, focal, 256, 256], np.float32),
                   (num_cameras + 2, 1))
    reg_poses = np.stack([
        get_pose_from_angles(np.zeros(1), np.array([np.pi / 2]),
                             camera_distance)[0, :3],
        get_pose_from_angles(np.zeros(1), np.array([-np.pi / 2]),
                             camera_distance)[0, :3]])
    return poses, intr, reg_poses


def surround_rig(num_views, camera_distance, fov_deg, min_elev, max_elev,
                 render_size, begin_rad=0.0, rng=None):
    """Generic surround rig: poses (N,3,4) + intrinsics (N,4)."""
    poses = random_surround_views(
        camera_distance, num_views, min_elev, max_elev, use_linspace=True,
        begin_rad=begin_rad, rng=rng)[:, :3]
    focal = render_size / (2 * np.tan(np.radians(fov_deg / 2)))
    intr = np.tile(np.array(
        [focal, focal, render_size / 2, render_size / 2], np.float32),
        (num_views, 1))
    return poses, intr
