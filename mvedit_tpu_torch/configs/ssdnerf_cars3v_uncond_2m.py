"""The port's copy of `configs/ssdnerf_cars3v_uncond_2m.py`
(the original imports JAX).

SSDNeRF paper preset: cars3v_uncond_2m — unconditional generation
trained from only 3 views per scene (ref
configs/paper_cfgs/ssdnerf_cars3v_uncond_2m.py: num_train_imgs=3,
2000000 iters, single extra_scene_step stage)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=2000000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    num_train_imgs=3,
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
