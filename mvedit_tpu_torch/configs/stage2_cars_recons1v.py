"""The port's copy of `configs/stage2_cars_recons1v.py`
(the original imports JAX).

Stage-2 preset (ref configs/paper_cfgs/stage2_cars_recons1v.py): resume
from a stage-1 scene-code cache (scene_cache.npz in --work-dir) and train
the diffusion prior on top."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=80000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    init_scene_cache="scene_cache.npz",
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
