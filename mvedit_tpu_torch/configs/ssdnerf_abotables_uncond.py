"""The port's copy of `configs/ssdnerf_abotables_uncond.py`
(the original imports JAX).

SSDNeRF paper preset: abotables_uncond (ref configs/paper_cfgs/ssdnerf_abotables_uncond.py:
code (3,6,128,128), total_iters 1000000)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=1000000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="abotables",
    single_view_recons=False,
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
