"""SSDNeRF evaluation CLI (counterpart of `tools/test_ssdnerf.py`): renders
held-out views from the cached scene codes, or from codes reconstructed by
`val_optim` on each scene's first N views (`--recons-views N`, then the
view after them is held out), and prints PSNR and SSIM.

  python -m mvedit_tpu_torch.tools.test_ssdnerf --config CFG --data DIR \\
      --work-dir work_dirs/cars [--recons-views 1]

Runs on the card unless `--device cpu`. Like the reference's CLI it
reports no FID / KID; `tools.inception_stat` writes a dataset's Inception
statistics and `utils/evaluation.py` has `fid_from_feats` / `kid_from_feats`.
"""
import argparse
import os

import numpy as np
import torch

__all__ = ["eval_denoiser", "main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--num-scenes", type=int, default=8)
    ap.add_argument("--recons-views", type=int, default=None,
                    help="N>0: reconstruct each scene's code from its "
                         "first N views via val_optim; default from the "
                         "config's train_config['recons_views']")
    ap.add_argument("--recons-steps", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def eval_denoiser(cfg_mod, device):
    """The denoiser the recons eval uses: the config's `build_denoiser`
    from a CPU generator of seed 0, whatever seed the run trained with
    (the reference rebuilds it from PRNGKey(0)); the checkpoint's params,
    a LoRA recipe's LoRA alone, go on top of it."""
    return cfg_mod.build_denoiser(torch.Generator().manual_seed(0), device)


def main(argv=None):
    """Prints and returns {"psnr", "ssim", "scenes"}."""
    args = parse_args(argv)
    from ..datasets import ShapeNetSRN
    from ..models.ssdnerf import (FileSceneCodeCache, SceneCodeCache,
                                  make_val_optim, module_apply, tanh_code)
    from ..models.triplane import triplane_point_decode
    from ..models.volume_renderer import render_rays
    from ..runner.trainer import CheckpointHook
    from ..utils.evaluation import eval_psnr, eval_ssim
    from ..utils.geometry import get_ray_directions, get_rays
    from .train_ssdnerf import load_config

    device = torch.device(args.device)
    cfg_mod = load_config(args.config)
    cfg = cfg_mod.ssdnerf_config
    dataset = ShapeNetSRN(args.data)
    state, step = CheckpointHook.load(args.work_dir, device=device)
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {args.work_dir}")
    recons_views = args.recons_views
    if recons_views is None:
        recons_views = cfg_mod.train_config.get("recons_views", 0)
    cache = None
    if not recons_views:
        npz = os.path.join(args.work_dir, "scene_cache.npz")
        if os.path.exists(npz):
            cache = SceneCodeCache.load(npz)
        else:
            cache = FileSceneCodeCache.load(
                os.path.join(args.work_dir, "code"))
    print(f"eval at step {step}"
          + (f", {recons_views}-view reconstruction" if recons_views
             else ", cached codes"))

    def rays(scene, views):
        h, w = scene["hw"]
        pose = torch.as_tensor(scene["poses"][views], device=device)
        intr = torch.as_tensor(scene["intrinsics"][views], device=device)
        return get_rays(get_ray_directions(h, w, intr), pose, norm=True)

    val_optim = None
    if recons_views:
        from ..models.diffusion import schedulers as S
        schedule = S.sd_schedule(prediction_type="v_prediction")
        denoise_apply = None
        if "denoiser" in state and hasattr(cfg_mod, "build_denoiser"):
            denoise_apply = module_apply(eval_denoiser(cfg_mod, device))
        val_optim = make_val_optim(
            denoise_apply, cfg.triplane, cfg, schedule,
            n_steps=args.recons_steps,
            prior_weight=0.0 if denoise_apply is None else 1e-4)

    psnrs, ssims = [], []
    for i in range(min(args.num_scenes, len(dataset))):
        scene = dataset[i]
        h, w = scene["hw"]
        if recons_views:
            k = min(recons_views, len(scene["poses"]) - 1)
            cro, crd = rays(scene, slice(0, k))
            cond = {"rays_o": cro.reshape(1, -1, 3),
                    "rays_d": crd.reshape(1, -1, 3),
                    "rgb": torch.as_tensor(scene["images"][:k],
                                           device=device).reshape(1, -1, 3)}
            code_raw, _ = val_optim(
                state.get("denoiser"),
                torch.zeros((1, *cfg.latent_shape), device=device),
                state["decoder"], cond,
                torch.Generator(device=device).manual_seed(i))
            code = tanh_code(code_raw)[0]
            eval_idx = k
        else:
            code = tanh_code(torch.as_tensor(
                np.asarray(cache.get_code(i), np.float32), device=device))
            eval_idx = 0
        ro, rd = rays(scene, slice(eval_idx, eval_idx + 1))

        def decode(x):
            s, c = triplane_point_decode(state["decoder"], code,
                                         x.reshape(-1, 3), None,
                                         cfg.triplane)
            return s.reshape(x.shape[:-1]), c.reshape(*x.shape[:-1], 3)
        with torch.no_grad():
            out = render_rays(decode, ro.reshape(-1, 3), rd.reshape(-1, 3),
                              cfg.render, bg_color=1.0)
        img = out["rgb"].reshape(h, w, 3).cpu().numpy()
        gt = scene["images"][eval_idx]
        psnrs.append(float(eval_psnr(img[None], gt[None])[0]))
        ssims.append(eval_ssim(img, gt))
    res = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "scenes": len(psnrs)}
    print(f"PSNR {res['psnr']:.2f}  SSIM {res['ssim']:.4f} "
          f"over {len(psnrs)} scenes")
    return res


if __name__ == "__main__":
    main()
