"""The port's copy of `configs/ssdnerf_chairs_recons2v.py`
(the original imports JAX).

SSDNeRF paper preset: chairs_recons2v (ref
configs/paper_cfgs/multiview_recons/ssdnerf_chairs_recons2v.py)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=80000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="chairs",
    recons_views=2,
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
