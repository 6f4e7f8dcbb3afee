"""How `zero123plus_v12` builds from the seed, serves a request, and is judged.

The port's `Adapter3DRunner` builds Zero123++'s models on the card
(`load_zero123plus`, `load_zero123plus_normal`); the benchmark hands it
its own weights (`harness/weights.py`) through the runner's initialiser
hook, so that the reference (`reference/zero123plus.py` on
`reference/diffusion.py`, the same parameter names) draws the same values
from the seed. Set-up checks that the program built the configuration's
widths and stops with an error where it did not. A request is the mix's
`call` on the runner's public endpoint, `run_zero123plus`: the RGB pass
and the normal pass, whose grids must both be finite and of the grid's
shape.

Each Zero123++ UNet's calls are split by their reference mode, so that
the write pass (`z123_write`) and the read pass (`z123_read`) are sites of
their own; a call carries the seed tag of the UNet it ran (the RGB one or
the normal one) as its first argument. `dot_product_attention`'s paths,
the flash kernel, the plain and the chunked attention, are sites of their
own too (not captured), so that each attention call's device time falls in
one range.

The check follows the program call by call from the program's own state:
one call of each of the write pass, the read pass, the normal ControlNet,
the VAE's encode and decode, the vision tower and two of the pipeline's
own steps (`condition`: the CFG batch's prompt embeds, the tower's embed
ramped onto text_uncond; `solver`: the CFG combine and the
Euler-ancestral step), drawn from the seed inside the window's second
request, is copied to the host with its inputs and its output, and the
reference recomputes it in float32 from those inputs once the program is
freed; the condition's text_uncond and ramping, and the step's guidance
scale and schedule, are the configuration's, not the program's. Each
number (`<site>_rel`) is the worst leaf's |program - reference|_2 /
|reference|_2: the write pass's leaves are its output and every stored
state, the ControlNet's its residuals. Per-call outputs are compared,
never the sampled grids, whose ancestral noise amplifies rounding.
"""
import importlib
import json
import sys

import numpy as np
import torch

from portbench.configs.mvedit_sd15 import MVEditSystem, tree_rel
from portbench.harness.capture import to_device, to_host
from portbench.harness.weights import seed_params_
from portbench.reference import diffusion as RD
from portbench.reference import zero123plus as RZ
from portbench.reference.flops import call_flops

__all__ = ["build"]

SITES = ("z123_write", "z123_read", "controlnet", "vae_encode",
         "vae_decode", "vision")
# the pipeline's own steps, judged beside the models' calls:
# `Zero123PlusPipeline._encode_condition` (the vision tower's embed ramped
# onto text_uncond, the CFG batch's prompt embeds) and `_guided_step` (the
# CFG combine and the Euler-ancestral step)
STEPS = (("condition", "_encode_condition"), ("solver", "_guided_step"))
# dot_product_attention's paths (`models/diffusion/attention.py`)
ATTENTION_SITES = (("attn_kernel", "flash_attention"),
                   ("attn_plain", "_plain_attention"),
                   ("attn_chunked", "_chunked_attention"))


def build(cfg, seed, device, preset):
    return Zero123PlusSystem(cfg, seed, device, preset == "tiny")


class Passes:
    """A UNet's calls routed by reference mode: `write(tag, ...)` for
    `mode.reference == "write"`, `read(tag, ...)` for the rest, `tag`
    naming the UNet. Sites wrap these two methods."""

    def __init__(self):
        self.forwards = {}
        self.unets = []

    def bind(self, unet, tag):
        self.forwards[tag] = unet.forward
        self.unets.append(unet)

        def forward(*args, **kwargs):
            mode = kwargs.get("mode")
            route = self.write if getattr(mode, "reference", None) \
                == "write" else self.read
            return route(tag, *args, **kwargs)
        unet.forward = forward

    def write(self, tag, *args, **kwargs):
        return self.forwards[tag](*args, **kwargs)

    def read(self, tag, *args, **kwargs):
        return self.forwards[tag](*args, **kwargs)

    def unbind(self):
        for unet in self.unets:
            del unet.forward
        self.unets, self.forwards = [], {}


class _StepSnap:
    """A pipeline step's capture: its inputs after the pipeline itself
    (whose models the reference must not hold) and before the solver's
    state, and its first output."""

    @staticmethod
    def before(args, kwargs):
        return None

    @staticmethod
    def after(args, kwargs, out, pre):
        out = out[0] if isinstance(out, tuple) else out
        return to_host(args[1:6]), {}, to_host(out)


class _Condition(RZ.CLIPVision):
    """The reference's prompt embeds of the CFG batch from the vision
    tower: [text_uncond; text_uncond + the embed ramped per token], with
    the configuration's text_uncond (zeros) and ramping (linspace)."""

    def __init__(self, cfg, shape):
        super().__init__(cfg)
        self.shape = tuple(shape)

    def condition(self, pixels):
        uncond = torch.zeros(self.shape, device=pixels.device)
        ramping = np.linspace(0, 1, self.shape[1])
        return torch.cat([uncond, RZ.encode_condition(
            self, pixels, uncond, ramping)], 0)


class _Solver(torch.nn.Module):
    """The reference's CFG combine and Euler-ancestral step; `quant`
    rounds its inputs (the control's float8)."""

    def __init__(self, scale):
        super().__init__()
        self.scale, self.quant = scale, RD.Quant()
        self.acp = RZ.sd_alphas_cumprod()

    def forward(self, latents, out, t, t_prev, noise):
        q = self.quant
        return RZ.cfg_euler_ancestral(
            self.acp, q(latents.float()), q(out.float()), self.scale, t,
            t_prev, q(noise.float()))


def _unet_cfg(d):
    d = dict(d)
    d["block_out_channels"] = tuple(d["block_out_channels"])
    d["attn_down"] = tuple(d["attn_down"])
    return d


class Zero123PlusSystem:
    def __init__(self, cfg, seed, device, tiny):
        import mvedit_tpu_torch.apis.runner as R
        self.cfg = dict(cfg, **cfg["tiny"]) if tiny else dict(cfg)
        self.seed, self.device, self.tiny = int(seed), device, tiny
        self.tags = {}             # id(module) -> its seed tag
        # the benchmark's weights, through the runner's initialiser
        R.init_random_ = self._seed_model
        self.runner = R.Adapter3DRunner(seed=self.seed, tiny_models=tiny,
                                        device=device)
        self.passes = Passes()
        self.site_tags = {}
        self.timer = None

    def _seed_model(self, module, generator):
        off = generator.initial_seed() - self.seed
        tag = f"{type(module).__name__}:{off}"
        self.tags[id(module)] = tag
        return seed_params_(module, self.seed, tag, self.device)

    # ------------------------------------------------------------------
    def install(self, sites, traffic):
        r = self.runner
        version = traffic["call"]["args"]["version"]
        rgb = r.load_zero123plus(version)
        nrm = r.load_zero123plus_normal(version)
        self.check_widths(rgb, nrm)
        for m in (rgb, nrm):
            self.passes.bind(m.unet, self.tags[id(m.unet)])
        sites.add("z123_write", self.passes, "write")
        sites.add("z123_read", self.passes, "read")
        for name, obj, attr in (("controlnet", nrm.controlnet, "forward"),
                                ("vae_encode", rgb.vae, "encode"),
                                ("vae_decode", rgb.vae, "decode"),
                                ("vision", rgb.vision, "forward")):
            sites.add(name, obj, attr)
            self.site_tags[name] = self.tags[id(obj)]
        att = importlib.import_module(
            "mvedit_tpu_torch.models.diffusion.attention")
        for name, attr in ATTENTION_SITES:
            sites.add(name, att, attr, capture=False)
        pipe = importlib.import_module(
            "mvedit_tpu_torch.pipelines.zero123plus").Zero123PlusPipeline
        for name, attr in STEPS:
            sites.add(name, pipe, attr, snap=_StepSnap)
        self.site_tags["condition"] = self.site_tags["vision"]
        self.site_tags["solver"] = "solver"

    def check_widths(self, rgb, nrm):
        """Stops the run where the program's Zero123++ models are not the
        configuration's: the UNets' and the ControlNet's widths, the
        vision tower's and the condition's shape."""
        c, bad = self.cfg, []

        def same(what, got, want):
            if got != want:
                bad.append(f"{what}: the program has {got!r}, the "
                           f"configuration {want!r}")
        for what, mod, key in (("unet", rgb.unet, "unet"),
                               ("normal_unet", nrm.unet, "normal_unet"),
                               ("controlnet", nrm.controlnet,
                                c["controlnet"]["unet"])):
            for k, v in _unet_cfg(c[key]).items():
                same(f"{what}.{k}", getattr(mod.cfg, k, None), v)
        for k, v in c["vision"].items():
            same(f"vision.{k}", getattr(rgb.vision.cfg, k, None), v)
        same("text_uncond", list(rgb.text_uncond.shape), c["text_uncond"])
        if bad:
            sys.exit("portbench: the program does not build the "
                     "configuration's Zero123++: " + "; ".join(bad))

    def phase_timer(self, on):
        if not on and self.timer is not None:
            # the program's counters of the request
            sys.stderr.write("portbench: z123 counts " + json.dumps(
                dict(self.timer.counts)) + "\n")
        self.timer = MVEditSystem.phase_timer(self, on)
        return self.timer

    def request(self, traffic, ctx, warmup=False):
        """One request: the mix's `call` on the runner."""
        call = traffic["call"]
        args = dict(call["args"], **(traffic.get("warmup", {})
                                     if warmup else {}))

        def value(v):
            if isinstance(v, str) and v[:1] == "@":
                return ctx[v[1:]]
            if isinstance(v, str) and v[:1] == "$":
                return self.cfg[v[1:]]
            return v
        grids = getattr(self.runner, call["method"])(
            **{k: value(v) for k, v in args.items()})
        shape = tuple(self.cfg["grid_hw"]) + (3,)
        ok = all(g.shape == shape and bool(np.isfinite(g).all())
                 for g in grids)
        return {"ok": ok}

    def free(self):
        self.passes.unbind()
        self.runner = None

    # ------------------------------------------------------------------
    def _factory(self, site):
        """(make, method) of the reference module a site calls."""
        c = self.cfg
        if site in ("z123_write", "z123_read"):
            return (lambda: RZ.UNet(RD.UNetCfg(**_unet_cfg(c["unet"]))),
                    "tagged")
        if site == "controlnet":
            cn = c["controlnet"]
            return (lambda: RD.ControlNet(
                RD.UNetCfg(**_unet_cfg(c[cn["unet"]])), cn["hint_strides"]),
                "forward")
        if site in ("vae_encode", "vae_decode"):
            v = dict(c["vae"])
            v["block_out_channels"] = tuple(v["block_out_channels"])
            return lambda: RD.VAE(RD.VAECfg(**v)), site[4:]
        if site == "vision":
            return lambda: RZ.CLIPVision(RZ.VisionCfg(**c["vision"])), \
                "forward"
        if site == "condition":
            return (lambda: _Condition(RZ.VisionCfg(**c["vision"]),
                                       c["text_uncond"]), "condition")
        if site == "solver":
            return lambda: _Solver(c["guidance_scale"]), "forward"
        raise KeyError(site)

    def reference_module(self, site, tag):
        make, method = self._factory(site)
        with torch.device(self.device):
            mod = make()
        seed_params_(mod, self.seed, tag, self.device)
        return mod.eval().requires_grad_(False), method

    def model_flops(self, sites):
        """Model FLOPs of every recorded call of the judged entries in the
        window: both UNets' write and read passes, the ControlNet, the
        VAE and the vision tower."""
        total = 0
        for name in SITES:
            if name not in sites.sites:
                continue
            make, method = self._factory(name)
            for sig, n in sites.sites[name].sigs.items():
                total += n * call_flops((name, self.tiny), make, method, sig)
        return total

    @torch.no_grad()
    def compare(self, captures, control=False):
        dev, nums = self.device, {}
        with RD.no_tf32():
            for site in SITES + tuple(n for n, _ in STEPS):
                if site not in captures:
                    continue
                args, kwargs, out = captures[site]
                tag = args[0] if site.startswith("z123_") \
                    else self.site_tags[site]
                mod, method = self.reference_module(site, tag)
                args, kwargs = to_device(args, dev), to_device(kwargs, dev)
                ref = getattr(mod, method)(*args, **kwargs)
                if control:
                    for sub in mod.modules():
                        if hasattr(sub, "quant"):
                            sub.quant = RD.Quant(fp8=True)
                    out = getattr(mod, method)(*args, **kwargs)
                nums[f"{site}_rel"] = tree_rel(out, ref)
                del mod, ref, out
        return nums
