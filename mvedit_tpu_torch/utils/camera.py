"""Camera rig math (world z-up, OpenCV camera convention).

Rebuilds the semantics of the reference camera utilities
(`lib/core/utils/camera_utils.py:7-211`): look-at rotations whose columns are
[side, -up, forward] (so +y is image-down = OpenCV), surround orbits around the
origin with z-up, von-Mises/uniform jittered rings, camera-anchored light
sampling, and azimuth-based view prompt suffixes.

A numpy-only copy of `mvedit_tpu/utils/camera.py` (importing that module
would pull in JAX through its package). Camera rigs are tiny and computed
once per pipeline call on the host; they reach the device as inputs.
"""
import math

import numpy as np

__all__ = [
    "look_at", "get_pose_from_angles", "surround_views",
    "random_surround_views", "light_sampling", "view_prompts",
    "intrinsics_from_fov",
]


def _normalize(v, axis=-1, eps=1e-8):
    return v / np.clip(np.linalg.norm(v, axis=axis, keepdims=True), eps, None)


def look_at(center, target, up):
    """Rotation matrices (..., 3, 3) with columns [s, -u, f] (OpenCV cam)."""
    center = np.asarray(center, np.float32)
    target = np.asarray(target, np.float32)
    up = np.broadcast_to(np.asarray(up, np.float32), center.shape)
    f = _normalize(target - center)
    s = _normalize(np.cross(f, up))
    u = _normalize(np.cross(s, f))
    return np.stack([s, -u, f], axis=-1)


def get_pose_from_angles(azi, elev, distance):
    """c2w poses (B, 4, 4) on a z-up orbit around the origin.

    azi/elev in radians, distance scalar or (B,).
    """
    azi = np.asarray(azi, np.float32)
    elev = np.asarray(elev, np.float32)
    pos_xy = np.stack([np.cos(azi), np.sin(azi)], axis=-1)
    pos = np.concatenate(
        [pos_xy * np.cos(elev)[..., None], np.sin(elev)[..., None]], axis=-1)
    pos = pos * np.asarray(distance, np.float32).reshape(-1, 1) \
        if np.ndim(distance) else pos * float(distance)
    rot = look_at(pos, np.zeros_like(pos), np.array([0.0, 0.0, 1.0], np.float32))
    n = azi.shape[0]
    poses = np.zeros((n, 4, 4), np.float32)
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = pos
    poses[:, 3, 3] = 1.0
    return poses


def surround_views(initial_pose, angle_amp=1.0, num_frames=60):
    """Spiral orbit through the initial camera position (ref :27-48)."""
    initial_pose = np.asarray(initial_pose, np.float32)
    rad = np.linspace(0, 2 * np.pi, num=num_frames, endpoint=False,
                      dtype=np.float32)
    pos0 = initial_pose[:3, -1]
    dist = np.linalg.norm(pos0)
    pos_n = pos0 / dist
    angle0 = math.asin(float(np.clip(pos_n[-1], -1, 1)))
    angles = angle0 * (np.sin(rad) * angle_amp + 1.0)
    rot2 = np.stack([np.cos(rad), -np.sin(rad), np.sin(rad), np.cos(rad)],
                    axis=-1).reshape(-1, 2, 2)
    xy0 = _normalize(pos_n[:2], axis=0)
    pos_xy = np.einsum("j,njk->nk", xy0, rot2)
    pos = np.concatenate(
        [pos_xy * np.cos(angles)[:, None], np.sin(angles)[:, None]],
        axis=-1) * dist
    rot = look_at(pos, np.zeros_like(pos), np.array([0, 0, 1], np.float32))
    poses = np.zeros((num_frames, 4, 4), np.float32)
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = pos
    poses[:, 3, 3] = 1.0
    return poses


def random_surround_views(camera_distance, num_cameras, min_angle=0.1,
                          max_angle=0.4, use_linspace=False, begin_rad=0.0,
                          uniform=True, rng=None):
    """Ring of cameras with random/linspace azimuth, random elevation
    (uniform-on-sphere when `uniform`), matching ref :105-124."""
    rng = rng or np.random.default_rng()
    if use_linspace:
        rad = np.linspace(np.pi / num_cameras, 2 * np.pi - np.pi / num_cameras,
                          num=num_cameras, dtype=np.float32)
    else:
        rad = rng.random(num_cameras).astype(np.float32) * (2 * np.pi)
    rad = rad + (begin_rad - rad[0])
    if uniform:
        angles = np.arcsin(
            rng.random(num_cameras).astype(np.float32)
            * (math.sin(max_angle) - math.sin(min_angle)) + math.sin(min_angle))
    else:
        angles = rng.random(num_cameras).astype(np.float32) \
            * (max_angle - min_angle) + min_angle
    return get_pose_from_angles(rad, angles, camera_distance)


def light_sampling(camera_poses, elev_range=(10.0, 90.0),
                   centered_light_views=None, rng=None):
    """Sample one light direction per camera, biased toward the camera
    hemisphere with elevation clamped to `elev_range` (ref :149-180).

    Returns (world_light_dir (N,3), cam_light_dir (N,3)).
    """
    rng = rng or np.random.default_rng()
    camera_poses = np.asarray(camera_poses, np.float32)
    cam_pos = _normalize(camera_poses[:, :3, 3])
    n = cam_pos.shape[0]
    # sample within unit circle (ref sample_within_circle, spread=0.5)
    r = np.sqrt(rng.random(n) * 0.5)
    theta = rng.random(n) * 2 * np.pi
    xy = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1).astype(np.float32)
    cam_elev = np.arcsin(np.clip(cam_pos[:, 2], -1, 1))
    d_max = np.clip(elev_range[1] * np.pi / 180 - cam_elev, -np.pi / 2, np.pi / 2)
    d_min = np.clip(elev_range[0] * np.pi / 180 - cam_elev, -np.pi / 2, np.pi / 2)
    y_min = -np.sin(d_max)
    y_max = -np.sin(d_min)
    mul = np.sqrt(np.clip(1 - xy[:, 0] ** 2, 0, None))
    y_min, y_max = y_min * mul, y_max * mul
    xy[:, 1] = xy[:, 1] * (y_max - y_min) / 2 + (y_max + y_min) / 2
    z = -np.sqrt(np.clip(1 - (xy * xy).sum(-1), 0, None))
    cam_light = np.concatenate([xy, z[:, None]], axis=-1).astype(np.float32)
    if centered_light_views is not None:
        cam_light[centered_light_views] = np.array([0, 0, -1], np.float32)
    world_light = np.einsum("nij,nj->ni", camera_poses[:, :3, :3], cam_light)
    return world_light, cam_light


def view_prompts(camera_poses, front_azi, camera_azi=None):
    """'side view' / 'view from behind' prompt suffixes by azimuth delta
    (ref :182-198)."""
    if camera_poses is not None:
        camera_poses = np.asarray(camera_poses)
        camera_azi = np.arctan2(camera_poses[:, 1, 3], camera_poses[:, 0, 3])
    delta = np.mod(np.asarray(camera_azi) - front_azi, 2 * np.pi)
    out = []
    for d in np.atleast_1d(delta):
        if d < np.pi / 6 or d > 11 * np.pi / 6:
            out.append("")
        elif d < 2 * np.pi / 3 or d > 4 * np.pi / 3:
            out.append("side view")
        else:
            out.append("view from behind")
    return out


def intrinsics_from_fov(fov_deg, h, w):
    """[fx, fy, cx, cy] for a pinhole camera with given vertical fov."""
    f = 0.5 * h / math.tan(0.5 * math.radians(fov_deg))
    return np.array([f, f, w / 2.0, h / 2.0], np.float32)
