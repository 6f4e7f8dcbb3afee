"""Rotation conversions and the camera pruning of the MVEdit view schedule
(counterpart of `mvedit_tpu/ops/rotation.py`): numpy on the host.

Quaternion camera distances feed `prune_cameras`' greedy min-importance
removal (ref `lib/pipelines/utils.py:350-379`).
"""
import numpy as np

__all__ = ["matrix_to_quaternion", "quaternion_to_matrix",
           "axis_angle_to_matrix", "get_camera_dists", "prune_cameras"]


def matrix_to_quaternion(m):
    """(..., 3, 3) -> (..., 4) wxyz."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    # robust branchless construction
    q_abs = np.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22], axis=-1)
    q_abs = np.sqrt(np.maximum(q_abs, 0.0))
    quat_by_w = np.stack(
        [q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1)
    quat_by_x = np.stack(
        [m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1)
    quat_by_y = np.stack(
        [m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1)
    quat_by_z = np.stack(
        [m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1)
    quats = np.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], -2)
    denom = 2.0 * np.maximum(q_abs[..., None], 0.1)
    quats = quats / denom
    best = np.argmax(q_abs, axis=-1)
    out = np.take_along_axis(quats, best[..., None, None].repeat(4, -1),
                             axis=-2)
    out = out[..., 0, :]
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def quaternion_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def axis_angle_to_matrix(axis_angle):
    angle = np.linalg.norm(axis_angle, axis=-1, keepdims=True)
    axis = axis_angle / np.clip(angle, 1e-8, None)
    half = angle[..., 0] / 2
    q = np.concatenate(
        [np.cos(half)[..., None], axis * np.sin(half)[..., None]], -1)
    return quaternion_to_matrix(q)


def get_camera_dists(poses, pos_weight=1.0):
    """Pairwise camera distance = quaternion angle + weighted position dist
    (pipelines/utils.py:350-363). poses: (N, 3, 4) numpy."""
    poses = np.asarray(poses)
    q = matrix_to_quaternion(poses[:, :3, :3])
    dots = np.clip(np.abs(q @ q.T), 0, 1)
    ang = 2 * np.arccos(dots)
    pos = poses[:, :3, 3]
    pd = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    return ang + pos_weight * pd


def prune_cameras(poses, keep_ids, max_num, pixel_dist_bonus=None):
    """Greedy min-importance camera removal (pipelines/utils.py:366-379):
    repeatedly drop the non-kept camera with the smallest distance to its
    nearest remaining neighbor (most redundant). Returns kept indices."""
    n = len(poses)
    alive = list(range(n))
    dists = get_camera_dists(poses)
    if pixel_dist_bonus is not None:
        dists = dists + np.asarray(pixel_dist_bonus)
    keep = set(int(k) for k in keep_ids)
    while len(alive) > max_num:
        best_i, best_score = None, np.inf
        for i in alive:
            if i in keep:
                continue
            others = [j for j in alive if j != i]
            score = dists[i, others].min()
            if score < best_score:
                best_score, best_i = score, i
        if best_i is None:
            break
        alive.remove(best_i)
    return np.asarray(alive)
