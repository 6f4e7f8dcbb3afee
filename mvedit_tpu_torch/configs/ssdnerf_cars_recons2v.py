"""The port's copy of `configs/ssdnerf_cars_recons2v.py`
(the original imports JAX).

SSDNeRF paper preset: cars_recons2v — 2-view reconstruction eval
(ref configs/paper_cfgs/multiview_recons/ssdnerf_cars_recons2v.py:
same model as cars_recons1v, val conditions on 2 observed views)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=80000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    recons_views=2,
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
