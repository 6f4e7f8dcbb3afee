"""The port's copy of `configs/ssdnerf_cars_recons8v.py`
(the original imports JAX).

SSDNeRF paper preset: cars_recons8v — 8-view reconstruction eval
(ref configs/paper_cfgs/multiview_recons/ssdnerf_cars_recons8v.py:
same model as cars_recons1v, val conditions on 8 observed views)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=80000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    recons_views=8,
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
