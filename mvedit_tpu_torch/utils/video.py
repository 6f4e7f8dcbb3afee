"""Orbit video export on the host (counterpart of
`mvedit_tpu/utils/video.py`): frames rendered along a `surround_views`
orbit, written as an mp4 through ffmpeg where it is installed and the
path ends in .mp4, else as a GIF through PIL (the reference's own two
routes).
"""
import shutil
import subprocess

import numpy as np

__all__ = ["write_video", "render_surround_video"]


def write_video(frames, path, fps=30):
    """frames: (N, H, W, 3) float in [0, 1] or uint8. Returns the path
    written (the .gif beside `path` when ffmpeg does not write it)."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    if shutil.which("ffmpeg") and path.endswith(".mp4"):
        n, h, w = frames.shape[:3]
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
               "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps),
               "-i", "-", "-c:v", "libx264", "-pix_fmt", "yuv420p",
               "-crf", "18", path]
        p = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        p.communicate(frames.tobytes())
        if p.returncode == 0:
            return path
    from PIL import Image
    gif_path = path if path.endswith(".gif") \
        else path.rsplit(".", 1)[0] + ".gif"
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(gif_path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return gif_path


def render_surround_video(render_frame_fn, initial_pose, intrinsics,
                          num_frames=60, path="out.mp4", fps=30,
                          angle_amp=1.0):
    """render_frame_fn(pose (3, 4), intrinsics (4,)) -> (H, W, 3) in
    [0, 1]; the frames of a `surround_views` orbit through
    `initial_pose`, written by `write_video`."""
    from .camera import surround_views
    poses = surround_views(initial_pose, angle_amp=angle_amp,
                           num_frames=num_frames)
    frames = [np.asarray(render_frame_fn(p[:3], intrinsics)) for p in poses]
    return write_video(np.stack(frames), path, fps)
