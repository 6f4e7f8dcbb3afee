"""The port's copy of `configs/ssdnerf_cars_recons1v_tiled.py`
(the original imports JAX).

SSDNeRF cars_recons1v with the TILED latent layout (ref
configs/new_cfgs/ssdnerf_cars_recons1v_tiled.py: code_permute=(1,2,0,3) +
code_reshape=(6, 128, 384) — the three planes tile side-by-side
spatially so the denoiser sees in_channels=6 and plane seams are learned
by convs rather than channel mixing)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=60000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    single_view_recons=True,
    cache_dtype="float16",
)


def build_denoiser(generator=None, device=None):
    # ref base_channels=80 for the wider tiled image (GroupNorm 16 groups)
    return build_denoiser_for(ssdnerf_config, generator, device, ch=80,
                              layout="tiled")
