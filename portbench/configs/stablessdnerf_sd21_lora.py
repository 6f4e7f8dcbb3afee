"""How `stablessdnerf_sd21_lora` builds from the seed, trains, and is judged.

The window drives the port's own training CLI, `mvedit_tpu_torch.tools.
train_ssdnerf.main`, on the recipe `configs/stablessdnerf_cars_lpips.py`
(a copy that names the captions file is written beside the run's data),
with the loader on the step's thread as the CLI runs it. The benchmark
stops the loop from outside: it hands the CLI a `Trainer` of its own
whose `run` makes the first `setup_iters` iterations, opens the window,
iterates until `--seconds` have passed (at least `min_iters`), and
closes it.

Weights are the benchmark's: the frozen UNet and the text tower through
the runner's initialiser hook (`harness/weights.py`), the LoRA factors,
the triplane decoder and LPIPS drawn anew over the CLI's own
(`init_models` wrapped). The set-up iterations take the benchmark's
draws (timesteps and noise) through the step's `draws`; their batches,
losses, the optimisers' first moments after the first step and the
parameters after the last are copied to the host.

The check follows those steps with the reference (`reference/ssdnerf.py`,
float32) from the same weights, batches and draws. The batches are the
program's loader's; one loader batch of the window, drawn from the seed,
is judged on its own against the dataset's files (`reference/srn.py`).
Every step, in set-up and in the window, takes the benchmark's draws, so
the window times the call the check follows (the step's own draws,
`draws=None`, are the same two calls on its generator).

- `loader_mismatch`: the judged batch's rays whose origin, direction,
  colour, patch place or caption is not that of a pixel of the claimed
  scene's files (exact, limit 0);
- `loader_ray_err`: the largest gap of a ray's direction to its pixel's
  ray recomputed in float64;

- `loss_rel`: each set-up step's diffusion and render loss, the worst
  |program - reference| / |reference|;
- `grad1_rel`: the first step's gradient as the optimisers hold it (m /
  (1 - b1)), the worst leaf's gap of norms over the larger of the
  reference leaf's norm and the median leaf's;
- `change3_rel`: the parameters' change over the set-up steps, likewise,
  over the leaves whose first reference gradient is at least a thousandth
  of the median leaf's.
"""
import os
import sys
import time
import types

import numpy as np
import torch

from portbench.harness.capture import to_host
from portbench.harness.weights import model_seed, seed_params_
from portbench.reference import diffusion as RD
from portbench.reference import ssdnerf as RS
from portbench.reference.srn import loader_numbers

__all__ = ["build"]

FULL_RECIPE = '''
from mvedit_tpu_torch.configs.stablessdnerf_cars_lpips import *  # noqa
from mvedit_tpu_torch.configs.stablessdnerf_cars_lpips import train_config
captions = {captions!r}
train_config = dict(train_config, max_iters=10 ** 9)
'''

TINY_RECIPE = '''
import dataclasses
import torch
from mvedit_tpu_torch.configs import stablessdnerf_cars_lpips as base
from mvedit_tpu_torch.models.diffusion.clip import CLIPTextConfig
from mvedit_tpu_torch.models.diffusion.unet import UNetConfig
from mvedit_tpu_torch.models.volume_renderer import RenderConfig
base.SD21_UNET = UNetConfig(dtype=torch.float32, **{unet!r})
base.SD21_TEXT = CLIPTextConfig(act="gelu", **{text!r})
base.ssdnerf_config = dataclasses.replace(
    base.ssdnerf_config, code_shape={code!r}, latent_shape={code!r},
    render=RenderConfig(num_samples={samples}, bound=0.5, grid_size=8),
    n_rays={rays})
ssdnerf_config = base.ssdnerf_config
train_config = dict(base.train_config, batch_size={batch},
                    patch_size={patch}, max_iters=10 ** 9)
captions = {captions!r}


def build_denoiser(generator=None, device=None):
    return base.build_denoiser(generator, device)


def make_cond_fn(device=None):
    return base.make_cond_fn(device)
'''


def build(cfg, seed, device, preset):
    return LoRATrainSystem(cfg, seed, device, preset == "tiny")


def fill_(named, seed, tag, device, std):
    """The benchmark's values for `named` [(name, tensor)], in the sorted
    order of their names: one normal draw from the seed, each tensor's
    slice times std(name, tensor)."""
    named = sorted(named, key=lambda kv: kv[0])
    total = sum(t.numel() for _, t in named)
    gen = torch.Generator(device=device)
    gen.manual_seed(model_seed(seed, tag))
    buf = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for name, t in named:
            n = t.numel()
            t.copy_(buf[off:off + n].view(t.shape) * std(name, t))
            off += n


def _decoder_std(name, t):
    return t.shape[0] ** -0.5 if name.endswith(".w") else 0.0


def _lpips_std(name, t):
    return (t[0].numel()) ** -0.5 if name.endswith(".w") else 0.0


def _lora_std(name, t):
    return 0.01


def _is_lora_target(name, targets):
    return any(m in name for m in targets)


def lora_shapes(unet_params, targets, rank):
    """{path: (a shape, b shape)} of `init_lora`'s targets: every 2-D
    weight of an attention projection."""
    out = {}
    for name, w in unet_params.items():
        if name.endswith(".weight") and w.dim() == 2 and _is_lora_target(
                name[:-len(".weight")], targets):
            out[name[:-len(".weight")]] = ((rank, w.shape[1]),
                                           (w.shape[0], rank))
    return out


class LoRATrainSystem:
    def __init__(self, cfg, seed, device, tiny):
        import mvedit_tpu_torch.apis.runner as R
        self.cfg = dict(cfg, **cfg["tiny"]) if tiny else dict(cfg)
        self.seed, self.device, self.tiny = int(seed), device, tiny
        R.init_random_ = self._seed_model
        self.cap = types.SimpleNamespace(ids=[], batches=[], draws=[],
                                         metrics=[])
        self.calls = 0

    def _seed_model(self, module, generator):
        off = generator.initial_seed() - self.seed
        return seed_params_(module, self.seed,
                            f"{type(module).__name__}:{off}", self.device)

    def install(self, sites, traffic):
        """The CLI's entry points are wrapped while it runs (`train`)."""

    def phase_timer(self, on):
        return None

    def free(self):
        """The CLI's state lives inside `train_ssdnerf.main`, gone once it
        returns; the host copies stay for the check."""

    # ------------------------------------------------------------ the CLI
    def _init_models(self, cfg_mod, seed, device):
        """The CLI's models, with the benchmark's LoRA, decoder and LPIPS
        values drawn over the CLI's own."""
        decoder, net, lp = self._orig_init(cfg_mod, seed, device)
        fill_(RS.flat(decoder).items(), self.seed, "decoder", device,
              _decoder_std)
        fill_(list(net.named_parameters()), self.seed, "lora", device,
              _lora_std)
        fill_(RS.flat(lp["convs"]).items(), self.seed, "lpips", device,
              _lpips_std)
        self.cap.init = dict(decoder=to_host(decoder), lpips=to_host(lp),
                             lora={k: to_host(p) for k, p in
                                   net.named_parameters()})
        return decoder, net, lp

    def _make_cache(self, *a, **k):
        cache = self._orig_cache(*a, **k)
        gather = cache.gather

        def recorded(ids):
            if len(self.cap.ids) < self.setup_iters:
                self.cap.ids.append(np.array(ids))
            return gather(ids)
        cache.gather = recorded
        return cache

    def _make_train_step(self, *a, **k):
        step_fn = self._orig_step(*a, **k)
        setup = self.setup_iters

        def step(state, batch, generator=None, draws=None):
            i = self.calls
            self.calls += 1
            codes = state["codes"]
            gen = torch.Generator(device=codes.device)
            gen.manual_seed(model_seed(self.seed, f"draws:{i}"))
            draws = {"t": torch.randint(0, 1000, (codes.shape[0],),
                                        generator=gen, device=codes.device),
                     "noise": torch.randn(codes.shape, generator=gen,
                                          device=codes.device)}
            if i >= setup:
                return step_fn(state, batch, generator, draws)
            self.cap.batches.append(to_host(batch))
            self.cap.draws.append(to_host(draws))
            new, metrics = step_fn(state, batch, generator, draws)
            self.cap.metrics.append({k: float(v) for k, v in
                                     metrics.items()})
            if i == 0:
                self.cap.m1 = dict(lora=to_host(new["denoiser_opt"]["m"]),
                                   decoder=to_host(new["decoder_opt"]["m"]),
                                   codes=to_host(new["code_m"]))
            if i == setup - 1:
                self.cap.end = dict(lora=to_host(new["denoiser"]),
                                    decoder=to_host(new["decoder"]))
            return new, metrics
        return step

    def train(self, root, captions, traffic, seconds, hooks, begin, end,
              workdir):
        import mvedit_tpu_torch.models.ssdnerf as SN
        import mvedit_tpu_torch.runner.trainer as TR
        from mvedit_tpu_torch.tools import train_ssdnerf as T
        c = self.cfg
        self.setup_iters = int(traffic["setup_iters"])
        min_iters = int(traffic["min_iters"])
        recipe = os.path.join(workdir, "recipe.py")
        with open(recipe, "w") as f:
            if self.tiny:
                f.write(TINY_RECIPE.format(
                    unet=dict(c["unet"], block_out_channels=tuple(
                        c["unet"]["block_out_channels"]), attn_down=tuple(
                        c["unet"]["attn_down"])),
                    text={k: v for k, v in c["text_encoder"].items()
                          if k != "max_length"},
                    code=tuple(c["code_shape"]), samples=c["num_samples"],
                    rays=c["patch_size"] ** 2, batch=c["batch_size"],
                    patch=c["patch_size"], captions=captions))
            else:
                f.write(FULL_RECIPE.format(captions=captions))
        system = self
        timing = {}

        # the window's iteration whose loader batch the check judges
        judged = int(np.random.default_rng(self.seed).integers(min_iters))
        self.data = dict(root=root, captions=captions,
                         patch=None if not c.get("patch_size")
                         else int(c["patch_size"]))

        class BenchTrainer(TR.Trainer):
            def _iter(self, n=None):
                batch = next(self.data_iter)
                if n == judged:
                    # host tensors already: the copy takes microseconds
                    system.cap.loader = {k: to_host(v) if torch.is_tensor(v)
                                         else (list(v) if isinstance(v, list)
                                               else v)
                                         for k, v in batch.items()}
                self.state, metrics = self.train_step(self.state, batch,
                                                      self.generator)
                self.step += 1
                for h in self.hooks:
                    h.after_iter(self, metrics)

            def run(self, max_iters):
                for _ in range(system.setup_iters):
                    self._iter()
                begin()
                t0, n = time.perf_counter(), 0
                while n < min_iters or time.perf_counter() - t0 < seconds:
                    with hooks.request(n):
                        self._iter(n)
                    n += 1
                if system.device.type == "cuda":
                    torch.cuda.synchronize()
                timing.update(window_s=time.perf_counter() - t0, n=n)
                end()
                for h in self.hooks:
                    h.after_run(self)
                return self.state

        patches = [(T, "init_models", self._init_models),
                   (T, "_make_cache", self._make_cache),
                   (SN, "make_train_step", self._make_train_step),
                   (TR, "Trainer", BenchTrainer)]
        saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
        self._orig_init, self._orig_cache, self._orig_step = (
            saved[0][2], saved[1][2], saved[2][2])
        for m, a, v in patches:
            setattr(m, a, v)
        try:
            out = T.main(["--config", recipe, "--data", root, "--work-dir",
                          os.path.join(workdir, "work"), "--seed",
                          str(self.seed), "--device", str(self.device)])
        finally:
            for m, a, v in saved:
                setattr(m, a, v)
        n, w = timing["n"], timing["window_s"]
        self.n_scenes = out.cache.codes.shape[0]
        records = [dict(wall=s, ok=bool(np.isfinite(list(m.values())).all()))
                   for s, m in zip(out.step_seconds[-n:], out.metrics[-n:])]
        return dict(window_s=w, records=records, attempted=n,
                    failed=sum(not r["ok"] for r in records),
                    loader_s=out.loader_seconds[-n:],
                    step_s=out.step_seconds[-n:],
                    end_to_end={"train_step_s": w / n})

    # ------------------------------------------------------------ check
    def _train_cfg(self):
        c = self.cfg
        return dict(latent_shape=tuple(c["code_shape"]),
                    triplane={"bound": c["bound"]},
                    num_samples=c["num_samples"], bound=c["bound"],
                    patch_size=c["patch_size"],
                    lpips_weight=c["lpips_weight"],
                    denoiser_lr=c["denoiser_lr"], decoder_lr=c["decoder_lr"],
                    code_lr=c["code_lr"])

    def _reference_state(self, dev):
        """The reference's UNet and its starting state, drawn from the seed
        again; None where a drawn value differs from what the program
        started from."""
        c = self.cfg
        unet = RD.UNet(RS.unet_cfg(c["unet"])).to(dev)
        seed_params_(unet, self.seed, "UNet2DCondition:0", dev)
        unet.eval().requires_grad_(False)
        base = {k: p.detach() for k, p in unet.named_parameters()}
        init = self.cap.init
        lora = {k: torch.empty_like(v, device=dev)
                for k, v in init["lora"].items()}
        fill_(lora.items(), self.seed, "lora", dev, _lora_std)
        dec = {k: torch.empty_like(v, device=dev)
               for k, v in RS.flat(init["decoder"]).items()}
        fill_(dec.items(), self.seed, "decoder", dev, _decoder_std)
        conv = {k: torch.empty_like(v, device=dev)
                for k, v in RS.flat(init["lpips"]["convs"]).items()}
        fill_(conv.items(), self.seed, "lpips", dev, _lpips_std)
        shapes = lora_shapes(base, self.cfg["lora_targets"],
                             self.cfg["lora_rank"])
        same = set(shapes) == {k[len("lora."):-2] for k in lora}
        for k, v in lora.items():
            same &= bool(torch.equal(v.cpu(), init["lora"][k]))
        for k, v in dec.items():
            same &= bool(torch.equal(v.cpu(), RS.flat(init["decoder"])[k]))
        lp = {"convs": RS.unflat(init["lpips"]["convs"], conv),
              "lins": [torch.full_like(x, 1.0 / x.numel(), device=dev)
                       for x in init["lpips"]["lins"]]}
        lora_tree = {p: {"a": lora[f"lora.{p}.a"], "b": lora[f"lora.{p}.b"]}
                     for p in shapes}
        S = RS.init_state(lora_tree, RS.unflat(init["decoder"], dec), lp,
                          self.n_scenes, tuple(self.cfg["code_shape"]), dev)
        return unet, base, S, same

    def _follow(self, dev, prec, quant, half=False):
        unet, base, S, same = self._reference_state(dev)
        if quant:
            for sub in unet.modules():
                if hasattr(sub, "quant"):
                    sub.quant = RD.Quant(fp8=True)
        acp = RS.sd_acp()
        cfg = self._train_cfg()
        start = {"lora": {f"lora.{p}.{k}": v.clone() for p, ab in
                          S["lora"].items() for k, v in ab.items()},
                 "decoder": {k: v.clone() for k, v in
                             RS.flat(S["decoder"]).items()}}
        losses, g1 = [], None
        with RD.no_tf32():
            for i, (ids, batch, draws) in enumerate(zip(
                    self.cap.ids, self.cap.batches, self.cap.draws)):
                n = len(ids) // 2 if half else len(ids)
                b = {k: v[:n].to(dev) if torch.is_tensor(v) else v
                     for k, v in batch.items()}
                b["scene_ids"] = torch.as_tensor(ids[:n], device=dev).long()
                d = {k: v[:n].to(dev) for k, v in draws.items()}
                m, g = RS.train_step(S, b, d, unet, base, acp, cfg, prec)
                losses.append(m)
                if i == 0:
                    g1 = g
        endp = {"lora": {f"lora.{p}.{k}": v for p, ab in
                         S["lora"].items() for k, v in ab.items()},
                "decoder": RS.flat(S["decoder"])}
        return dict(losses=losses, g1=g1, start=start, end=endp, same=same)

    def compare(self, captures, control=False):
        dev = self.device
        if not self.cap.batches or not hasattr(self.cap, "end"):
            return {}
        ref = self._follow(dev, RS.Precision(), False)
        if control:
            # 1: the reference a precision lower; 2: the reference with
            # half of each batch left out, the means over the rest
            prog = (self._follow(dev, RS.Precision(low=True), True)
                    if control == 1 else
                    self._follow(dev, RS.Precision(), False, half=True))
            p_losses = prog["losses"]
            p_g1 = {"lora": prog["g1"]["lora"], "decoder":
                    prog["g1"]["decoder"], "codes": prog["g1"]["codes"]}
            p_end = prog["end"]
        else:
            p_losses = self.cap.metrics
            b1 = 0.9
            p_g1 = {"lora": {k: v / (1 - b1) for k, v in
                             self.cap.m1["lora"].items()},
                    "decoder": {k: v / (1 - b1) for k, v in
                                RS.flat(self.cap.m1["decoder"]).items()},
                    "codes": self.cap.m1["codes"] / (1 - b1)}
            p_end = {"lora": self.cap.end["lora"],
                     "decoder": RS.flat(self.cap.end["decoder"])}
        nums = {}
        if getattr(self.cap, "loader", None) is not None:
            nums["loader_mismatch"], nums["loader_ray_err"] = \
                loader_numbers(self.cap.loader, self.data["root"],
                               self.data["captions"], self.data["patch"],
                               control=control == 1)
        nums["loss_rel"] = max(
            abs(float(p[k]) - float(r[k])) / max(abs(float(r[k])), 1e-30)
            for p, r in zip(p_losses, ref["losses"]) for k in r)
        # the first gradient, leaf by leaf
        rg = dict(ref["g1"]["lora"])
        rg.update({f"decoder.{k}": v for k, v in
                   ref["g1"]["decoder"].items()})
        rg["codes"] = ref["g1"]["codes"]
        pg = dict(p_g1["lora"])
        pg.update({f"decoder.{k}": v for k, v in p_g1["decoder"].items()})
        pg["codes"] = p_g1["codes"]
        rn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
              rg.items()}
        med = float(np.median(list(rn.values())))
        g1 = {k: abs(float(torch.linalg.vector_norm(pg[k].double()))
                     - rn[k]) / max(rn[k], med, 1e-30) for k in rn}
        nums["grad1_rel"] = max(g1.values())
        # the change over the set-up steps, on the leaves that move
        keep = [k for k in rn if k != "codes" and rn[k] >= 1e-3 * med]
        rc, pc = {}, {}
        for k in keep:
            grp, key = (("decoder", k[len("decoder."):])
                        if k.startswith("decoder.") else ("lora", k))
            s = ref["start"][grp][key]
            rc[k] = float(torch.linalg.vector_norm(
                (ref["end"][grp][key] - s).double()))
            pc[k] = float(torch.linalg.vector_norm(
                (p_end[grp][key].to(s.device) - s).double()))
        cmed = float(np.median(list(rc.values()))) if rc else 0.0
        c3 = {k: abs(pc[k] - rc[k]) / max(rc[k], cmed, 1e-30) for k in rc}
        nums["change3_rel"] = max(c3.values(), default=float("inf"))
        if not ref["same"]:
            nums["loss_rel"] = float("inf")
        worst = {n: max(d, key=d.get) for n, d in (("grad1_rel", g1),
                                                   ("change3_rel", c3)) if d}
        sys.stderr.write(
            f"portbench: worst leaves {worst}; left out of the change "
            f"{sorted(set(rn) - set(rc) - {'codes'})[:8]} of "
            f"{len(set(rn) - set(rc)) - 1}; losses program "
            f"{p_losses} reference {ref['losses']}\n")
        return nums

    # ------------------------------------------------------------ work
    def step_flops(self):
        """Model FLOPs of one training iteration on the reference modules
        on the meta device: the LoRA UNet's forward and backward (the
        frozen base's input gradients and the LoRA's), and the render
        loss's decoder and LPIPS forward and backward."""
        from torch.utils.flop_counter import FlopCounterMode
        c = self.cfg
        meta = torch.device("meta")
        with torch.device(meta):
            unet = RD.UNet(RS.unet_cfg(c["unet"]))
        unet.requires_grad_(False)
        base = dict(unet.named_parameters())
        B, code = c["batch_size"], tuple(c["code_shape"])
        lora = {p: {"a": torch.empty(a, device=meta),
                    "b": torch.empty(b, device=meta)}
                for p, (a, b) in lora_shapes(base, c["lora_targets"],
                                             c["lora_rank"]).items()}
        codes = torch.empty((B, *code), device=meta)
        t = torch.zeros((B,), dtype=torch.long, device=meta)
        cond = torch.empty((B, 77, c["unet"]["cross_attention_dim"]),
                           device=meta)
        tri = c["triplane"]
        dims = [tri["base_layers"], tri["density_layers"],
                tri["color_layers"]]
        dec = {name: [{"w": torch.empty((a, b), device=meta),
                       "b": torch.empty((b,), device=meta)}
                      for a, b in zip(d[:-1], d[1:])]
               for name, d in zip(("base", "density", "color"), dims)}
        convs, cin = [], 3
        for v in RS.VGG16:
            if v != "M":
                convs.append({"w": torch.empty((v, cin, 3, 3), device=meta),
                              "b": torch.empty((v,), device=meta)})
                cin = v
        lp = {"convs": convs, "lins": [torch.empty((n,), device=meta)
                                       for n in (64, 128, 256, 512, 512)]}
        R = c["patch_size"] ** 2
        batch = {"rays_o": torch.empty((B, R, 3), device=meta),
                 "rays_d": torch.empty((B, R, 3), device=meta),
                 "rgb": torch.empty((B, R, 3), device=meta)}
        cfg = self._train_cfg()
        with FlopCounterMode(display=False) as fc:
            RS.diffusion_loss_grads(unet, base, lora, codes, t,
                                    torch.empty_like(codes), cond,
                                    RS.sd_acp(), code, chunk=B)
            leaves = [x.requires_grad_(True) for layer in dec.values()
                      for lay in layer for x in lay.values()]
            cc = codes.requires_grad_(True)
            loss = RS.render_loss(dec, torch.tanh(cc / 2) * 2, batch, lp,
                                  cfg, RS.Precision())
            torch.autograd.grad(loss, leaves + [cc], allow_unused=True)
        return int(fc.get_total_flops())

