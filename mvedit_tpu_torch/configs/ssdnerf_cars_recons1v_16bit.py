"""The port's copy of `configs/ssdnerf_cars_recons1v_16bit.py`
(the original imports JAX).

SSDNeRF cars_recons1v with a 16-bit scene-code cache (ref
configs/new_cfgs/ssdnerf_cars_recons1v_16bit.py: cache_16bit=True halves
host RAM for the 2458-scene code cache). Host cache dtype only — device
math stays fp32."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import (
    build_denoiser_for, make_paper_config)

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=80000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    single_view_recons=True,
    cache_dtype="float16",
)


def build_denoiser(generator=None, device=None):
    return build_denoiser_for(ssdnerf_config, generator, device)
