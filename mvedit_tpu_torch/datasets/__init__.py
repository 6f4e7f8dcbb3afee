"""Training datasets and batch iterators of the port (host numpy; the
loader hands CPU tensors to the train step)."""
from .parallel_zip import ParallelZipFile
from .shapenet_srn import ShapeNetSRN
from .nerf_synthetic import NerfSynthetic
from .objaverse_views import ObjaverseViews
from .loader import ray_batch_iterator, scene_batch_iterator

__all__ = ["ParallelZipFile", "ShapeNetSRN", "NerfSynthetic",
           "ObjaverseViews", "ray_batch_iterator", "scene_batch_iterator"]
