"""SSDNeRF training CLI (counterpart of `tools/train_ssdnerf.py`).

  python -m mvedit_tpu_torch.tools.train_ssdnerf \\
      --config mvedit_tpu_torch/configs/ssdnerf_cars.py \\
      --data /path/to/srn_cars --work-dir work_dirs/cars

The config module gives `ssdnerf_config`, `train_config` and, unless
`train_config["no_diffusion"]` (stage 1), `build_denoiser(generator,
device)`. `train_config` keys: batch_size, max_iters, log_interval,
ckpt_interval, init_scene_cache (a stage-1 cache to warm-start from),
cache_dtype, cache_backend ("filesystem": one file a scene under
`work_dir/code`, num_file_writers threads), num_train_imgs, patch_size,
use_lpips, lpips_weight. The run ends with `scene_cache.npz` (or the
filesystem cache's `steps.npz`) in the work dir; `--resume` reloads the
last checkpoint, its EMA and that cache. Runs on the card unless
`--device cpu`. The seeded initial weights come from CPU generators, so
that one seed gives one set of them on every device (`init_models`); the
run's own draws (rays, timesteps, noise) come from a generator on the
device.
"""
import argparse
import importlib.util
import os
import types

import numpy as np
import torch

from ..utils.profiling import (PhaseTimer, phase, phase_timer,
                               set_phase_timer, span)

__all__ = ["load_config", "init_models", "main"]


def load_config(path):
    spec = importlib.util.spec_from_file_location("config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--work-dir", default="work_dirs/ssdnerf")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="N>0: log held-out PSNR every N iters")
    ap.add_argument("--eval-scenes", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _make_cache(args, cfg, train_cfg, n_scenes, device):
    from ..models.ssdnerf import FileSceneCodeCache, SceneCodeCache
    init_cache = train_cfg.get("init_scene_cache")
    cache_dtype = train_cfg.get("cache_dtype", "float16")
    if train_cfg.get("cache_backend") == "filesystem":
        code_dir = os.path.join(args.work_dir, "code")
        writers = train_cfg.get("num_file_writers", 4)
        if init_cache or (args.resume and os.path.exists(
                os.path.join(code_dir, "steps.npz"))):
            cache = FileSceneCodeCache.load(init_cache or code_dir,
                                            num_file_writers=writers,
                                            device=device)
            print(f"loaded filesystem scene-code cache "
                  f"({cache.num_scenes} scenes)")
            return cache
        return FileSceneCodeCache(n_scenes, cfg.latent_shape, code_dir,
                                  dtype=cache_dtype,
                                  num_file_writers=writers, device=device)
    own = os.path.join(args.work_dir, "scene_cache.npz")
    path = own if args.resume and os.path.exists(own) else init_cache
    if path:
        if not os.path.isabs(path):
            path = os.path.join(args.work_dir, path)
        print(f"loaded scene-code cache from {path}")
        return SceneCodeCache.load(path, device=device)
    return SceneCodeCache(n_scenes, cfg.latent_shape, dtype=cache_dtype,
                          device=device)


def make_eval_fn(dataset, cache, cfg, n_scenes, device):
    """eval_fn(state, step) -> {"psnr"}: view 0 of the first scenes,
    rendered from their cached codes and the state's decoder."""
    from ..models.ssdnerf import tanh_code
    from ..models.triplane import triplane_point_decode
    from ..models.volume_renderer import render_rays
    from ..utils.evaluation import eval_psnr
    from ..utils.geometry import get_ray_directions, get_rays

    @torch.no_grad()
    def eval_fn(state, step):
        psnrs = []
        for i in range(min(n_scenes, len(dataset))):
            scene = dataset[i]
            code = tanh_code(torch.as_tensor(
                np.asarray(cache.get_code(i), np.float32), device=device))
            h, w = scene["hw"]
            pose = torch.as_tensor(scene["poses"][:1], device=device)
            intr = torch.as_tensor(scene["intrinsics"][:1], device=device)
            ro, rd = get_rays(get_ray_directions(h, w, intr), pose,
                              norm=True)

            def decode(x):
                s, c = triplane_point_decode(state["decoder"], code,
                                             x.reshape(-1, 3), None,
                                             cfg.triplane)
                return s.reshape(x.shape[:-1]), c.reshape(*x.shape[:-1], 3)
            out = render_rays(decode, ro.reshape(-1, 3), rd.reshape(-1, 3),
                              cfg.render, bg_color=1.0)
            img = out["rgb"].reshape(h, w, 3).cpu().numpy()
            psnrs.append(float(eval_psnr(img[None],
                                         scene["images"][:1])[0]))
        return {"psnr": float(np.mean(psnrs))}
    return eval_fn


def init_models(cfg_mod, seed, device):
    """The run's seeded initial weights on `device`: the triplane decoder
    and, unless `no_diffusion`, the denoiser, each from a CPU generator of
    `seed`, and the LPIPS params, where the recipe uses them, from one of
    seed 7. A LoRA recipe's checkpoints hold the LoRA alone, and
    `tools.test_ssdnerf` rebuilds the frozen base: CPU generators make
    that base the same whatever device trains or evaluates. Returns
    (decoder, denoiser module or None, LPIPS params or None)."""
    from ..models.triplane import triplane_init
    train_cfg = cfg_mod.train_config
    decoder = triplane_init(cfg_mod.ssdnerf_config.triplane,
                            torch.Generator().manual_seed(seed), device)
    net = None
    if not train_cfg.get("no_diffusion", False):
        net = cfg_mod.build_denoiser(torch.Generator().manual_seed(seed),
                                     device)
    lpips_params = None
    if train_cfg.get("use_lpips"):
        from ..models.losses import lpips_init
        lpips_params = lpips_init(torch.Generator().manual_seed(7), device)
    return decoder, net, lpips_params


def main(argv=None):
    """Trains; returns a namespace of the trainer, the cache, the EMA, each
    step's metrics (floats) and the per-step host times of the loader and
    of the step (the latter ends in the cache's copy to the host, which
    waits for the device): the durations of the `loader` and `step`
    phases of the installed `PhaseTimer`, or of one the run installs for
    itself."""
    args = parse_args(argv)
    from ..datasets import ShapeNetSRN, ray_batch_iterator
    from ..models.diffusion import schedulers as S
    from ..models.ssdnerf import (adam_init, make_train_step,
                                  module_apply, module_params)
    from ..runner.trainer import (CheckpointHook, EmaHook, EvalHook,
                                  LogHook, Trainer)

    device = torch.device(args.device)
    cfg_mod = load_config(args.config)
    cfg = cfg_mod.ssdnerf_config
    train_cfg = cfg_mod.train_config
    dataset = ShapeNetSRN(args.data,
                          caption_path=getattr(cfg_mod, "captions", None))
    print(f"dataset: {len(dataset)} scenes")
    cache = _make_cache(args, cfg, train_cfg, len(dataset), device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    schedule = S.sd_schedule(prediction_type="v_prediction")
    # the denoiser from the run's seed, as the reference builds it from
    # PRNGKey(seed); `tools.test_ssdnerf` rebuilds it from seed 0, the
    # frozen weights of a LoRA recipe included
    decoder, net, lpips_params = init_models(cfg_mod, args.seed, device)
    with_diffusion = net is not None
    state = {"decoder": decoder, "decoder_opt": adam_init(decoder)}
    denoise_apply = None
    if with_diffusion:
        denoise_apply = module_apply(net)
        state["denoiser"] = module_params(net)
        state["denoiser_opt"] = adam_init(state["denoiser"])
    step_fn = make_train_step(denoise_apply, cfg.triplane, cfg, schedule,
                              with_diffusion=with_diffusion,
                              lpips_params=lpips_params,
                              lpips_weight=train_cfg.get("lpips_weight",
                                                         1.2),
                              patch_size=train_cfg.get("patch_size"))
    start, ema = 0, None
    if args.resume:
        restored, start = CheckpointHook.load(args.work_dir, device=device)
        if restored:
            ema = restored.pop("ema", None)
            state.update(restored)
            print(f"resumed from step {start}")

    data = ray_batch_iterator(dataset, train_cfg["batch_size"], cfg.n_rays,
                              seed=args.seed, skip_iter=start,
                              num_train_imgs=train_cfg.get("num_train_imgs"),
                              patch_size=train_cfg.get("patch_size"))
    cond_fn = getattr(cfg_mod, "make_cond_fn", None)
    cond_fn = cond_fn(device) if cond_fn else None
    metrics_seen = []

    # the `loader` and `step` phases wait for nothing of their own: the
    # step ends in the cache's copy to the host
    def timed_batches():
        while True:
            with phase("loader"):
                batch = next(data)
            yield batch

    def wrapped_step(state, batch, generator):
        with phase("step"):
            ids = batch.pop("scene_ids")
            caps = batch.pop("captions", None)
            with span("step.h2d"):
                batch = {k: v.to(device) if torch.is_tensor(v) else v
                         for k, v in batch.items()}
            if cond_fn is not None and caps is not None:
                with span("step.cond"):
                    batch["cond"] = cond_fn(caps)
            with span("step.gather"):
                codes, m, v, steps = cache.gather(ids)
            state = dict(state, codes=codes, code_m=m, code_v=v,
                         code_steps=steps)
            with span("step.update"):
                state, metrics = step_fn(state, batch, generator)
            with span("step.scatter"):
                cache.scatter(ids, state.pop("codes"), state.pop("code_m"),
                              state.pop("code_v"), state.pop("code_steps"))
        metrics_seen.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    ema_hook = EmaHook(keys=("denoiser",), interval=1) \
        if with_diffusion else None
    if ema_hook is not None and ema is not None:
        ema_hook.ema = ema
    hooks = [
        *([ema_hook] if ema_hook else []),
        LogHook(args.work_dir, interval=train_cfg.get("log_interval", 50)),
        CheckpointHook(args.work_dir,
                       interval=train_cfg.get("ckpt_interval", 2000)),
    ]
    if args.eval_interval:
        hooks.append(EvalHook(make_eval_fn(dataset, cache, cfg,
                                           args.eval_scenes, device),
                              args.work_dir, interval=args.eval_interval))
    trainer = Trainer(wrapped_step, state, timed_batches(), hooks,
                      generator=gen)
    trainer.step = start
    # the run's phases go to the installed timer, else to one of its own
    pt = phase_timer()
    own = pt is None
    if own:
        pt = PhaseTimer(keep_spans=False)
        set_phase_timer(pt)
    n0 = {k: len(pt.durations[k]) for k in ("loader", "step")}
    try:
        trainer.run(args.max_iters or train_cfg["max_iters"])
    finally:
        if own:
            set_phase_timer(None)
    cache.save(os.path.join(args.work_dir, "scene_cache.npz"))
    print("done")
    return types.SimpleNamespace(
        trainer=trainer, cache=cache, ema=ema_hook and ema_hook.ema,
        metrics=metrics_seen,
        loader_seconds=pt.durations["loader"][n0["loader"]:],
        step_seconds=pt.durations["step"][n0["step"]:])


if __name__ == "__main__":
    main()
