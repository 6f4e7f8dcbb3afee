"""The port's copy of `configs/stage1_cars_recons16v_16bit_filesystem.py`
(the original imports JAX).

Stage-1 auto-decoder with the FILESYSTEM scene-code cache (ref
configs/new_cfgs/stage1_cars_recons16v_16bit_filesystem.py: per-scene
code files under work_dir/code written by num_file_writers async
threads — for corpora whose codes exceed host RAM)."""
from mvedit_tpu_torch.configs._ssdnerf_paper_base import make_paper_config

ssdnerf_config = make_paper_config()

train_config = dict(
    batch_size=8,
    max_iters=40000,
    log_interval=50,
    ckpt_interval=2000,
    dataset="cars",
    recons_views=16,
    no_diffusion=True,
    cache_dtype="float16",
    cache_backend="filesystem",
    num_file_writers=4,
)


def build_denoiser(generator=None, device=None):
    return None  # stage 1 trains no denoiser
