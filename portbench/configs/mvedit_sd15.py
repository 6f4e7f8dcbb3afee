"""How `mvedit_sd15` builds from the seed, serves a request, and is judged.

The port's `Adapter3DRunner` builds its models on the card; the benchmark
hands it its own weights (`harness/weights.py`) through the runner's
initialiser hook, so that the reference (`reference/diffusion.py`, the
same parameter names) draws the same values from the seed. Requests go
through the runner's public endpoints, `run_3d_to_3d` and `run_retex`.

The check follows the program step by step from the program's own state:
one call of each judged entry, drawn from the seed inside the window's
second request, is copied to the host with its inputs and its output,
and the reference recomputes it from those inputs once the program is
freed:

- `unet_rel`, `controlnet_<kind>_rel`, `vae_decode_rel`: the worst
  leaf's |program - reference|_2 / |reference|_2, the reference in
  float32;
- `vae_encode_rel_vs_fp8`: the encoder's such error over the error of
  the reference in float8 on the same call (the control reads 1);
- `segment_err`: the fits' gradient sums against a float64 sum, in units
  of a bfloat16 rounding of each row's absolute sum;
- `raster_mismatch`: pixels whose face or depth key differ from the plain
  selection (exact by design, limit 0);
- `gather_mismatch`, `gather_mismatch@render_all`: elements of one row
  gather (`ops/segment.py::gather_rows`, the fits' and render-all's field
  and mesh lookups), drawn over all of the request's calls and over those
  inside `_render_all`, that differ from plain indexing (exact, limit 0);
- `fit_step_rel`: one optimiser step of the fits (`torch.optim.Adam.
  step`, drawn over the request's steps) recomputed in float64 from its
  own parameters, gradients and moments: the worst parameter's error of
  the change, over the change's norm;
- `fit_steps_missing`: |the request's optimiser steps - the steps its
  schedule makes| (the mix's `fit_steps`; exact, limit 0);
- `bake_coverage`, `bake_rel`: the bake's atlas against a plain UV
  raster and the field written out, from the bake's own mesh, UV layout
  and field (texels whose coverage differs; the albedo's relative L2
  over the texels both cover);
- `dilation_rel`: the atlas's edge dilation against a float64 one.

A request's call is the mix's `call`: the runner's endpoint `method`,
with `@name` arguments taken from the loop (`input`, `prompt`, `seed`,
`out_path`, the mix's `extra_inputs`) and `$key` ones from the
configuration; the warm-up request overrides them with the mix's
`warmup`.
"""
import importlib
import os

import numpy as np
import torch

from portbench.harness.capture import to_device, to_host
from portbench.harness.weights import seed_params_
from portbench.reference import diffusion as RD
from portbench.reference.bake import bake_numbers, dilation_rel
from portbench.reference.fits import adam_step_error, gather_mismatch
from portbench.reference.flops import call_flops
from portbench.reference.raster import raster_select_reference
from portbench.reference.segment import segment_error

__all__ = ["build"]

DIFFUSION_SITES = ("unet", "controlnet_tile", "controlnet_depth",
                   "vae_decode", "vae_encode")
# sites whose error is judged in units of the control's on the same call:
# the encoder's relative error follows its input (renders of the fits'
# fields), 0.006-0.040 over seeds, the control's 8-14 times that
IN_CONTROL_UNITS = ("vae_encode",)
IP_TAG = "ip_branches"


def _is_ip(name):
    return ".ip_to_" in name


def build(cfg, seed, device, preset):
    return MVEditSystem(cfg, seed, device, preset == "tiny")


def _leaves(x):
    if torch.is_tensor(x):
        yield (), x
    elif isinstance(x, dict):
        for k, v in x.items():
            for p, t in _leaves(v):
                yield (k,) + p, t
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            for p, t in _leaves(v):
                yield (i,) + p, t


def tree_rel(out, ref):
    """The worst leaf's relative L2 distance, over the leaves of `ref`
    (the program's leaves at the same places)."""
    got = dict(_leaves(out))
    worst = 0.0
    for path, r in _leaves(ref):
        if path not in got:
            return float("inf")
        o = got[path].to(r.device).double()
        r = r.double()
        if o.shape != r.shape:
            return float("inf")
        d = float(torch.linalg.vector_norm(o - r))
        n = float(torch.linalg.vector_norm(r))
        worst = max(worst, d / max(n, 1e-30))
    return worst


class MVEditSystem:
    def __init__(self, cfg, seed, device, tiny):
        import mvedit_tpu_torch.apis.runner as R
        self.cfg = dict(cfg, **cfg["tiny"]) if tiny else dict(cfg)
        self.seed, self.device, self.tiny = int(seed), device, tiny
        # the benchmark's weights, through the runner's initialiser
        R.init_random_ = self._seed_model
        self.runner = R.Adapter3DRunner(seed=self.seed, tiny_models=tiny,
                                        device=device)
        self.kinds = tuple(self.cfg["controlnets"])
        # IP-Adapter's UNet branches are drawn when a request enables it:
        # the benchmark's draw replaces the runner's
        enable = self.runner.enable_ip_adapter

        def enable_ip_adapter(m, image, **kw):
            ctx = enable(m, image, **kw)
            seed_params_(m.unet, self.seed, IP_TAG, self.device,
                         only=_is_ip)
            return ctx
        self.runner.enable_ip_adapter = enable_ip_adapter

    def _seed_model(self, module, generator):
        off = generator.initial_seed() - self.seed
        return seed_params_(module, self.seed,
                            f"{type(module).__name__}:{off}", self.device)

    # ------------------------------------------------------------------
    def install(self, sites, traffic):
        r = self.runner
        self.ip = "in_image" in traffic.get("extra_inputs", {})
        self.fit_steps = int(traffic["fit_steps"])
        m = r.load_stable_diffusion()
        nets = r.load_controlnets(self.kinds)
        r.load_lpips()
        if not self.tiny:
            r.load_image_enhancer()
        imp = importlib.import_module
        sites.add("unet", m.unet, "forward")
        for kind, net in zip(self.kinds, nets):
            sites.add(f"controlnet_{kind}", net, "forward")
        sites.add("vae_decode", m.vae, "decode")
        sites.add("vae_encode", m.vae, "encode")
        sites.add("segment_sum", imp("mvedit_tpu_torch.ops.segment"),
                  "segment_sum")
        sites.add("raster_select", imp(
            "mvedit_tpu_torch.models.mesh.rasterize"), "raster_select")
        for mod in ("attention", "vae", "ip_adapter", "clip"):
            sites.add("attention" if mod == "attention" else
                      f"attention.{mod}", imp(
                          f"mvedit_tpu_torch.models.diffusion.{mod}"),
                      "dot_product_attention", capture=False)
        # the pipelines are imported before their functions are wrapped
        for mod in ("mvedit_3d", "texture"):
            imp(f"mvedit_tpu_torch.pipelines.{mod}")
        sites.add("render_all", imp(
            "mvedit_tpu_torch.pipelines.mvedit_3d").MVEdit3DPipeline,
            "_render_all", capture=False)
        seg = imp("mvedit_tpu_torch.ops.segment")
        sites.add_function("gather_rows", seg.gather_rows,
                           scopes=(None, "render_all"))
        sites.add("fit_step", torch.optim.Adam, "step", snap=AdamSnap)
        sites.add_function("bake_texture", imp(
            "mvedit_tpu_torch.models.mesh.renderer").bake_texture)
        sites.add_function("edge_dilation", imp(
            "mvedit_tpu_torch.ops.image").edge_dilation)

    def phase_timer(self, on):
        from mvedit_tpu_torch.utils import profiling as P
        if not on:
            P.set_phase_timer(None)
            return None
        from portbench.harness.trace import Trace

        class TickTimer(P.PhaseTimer):
            def tick(self, name, *tensors, sig=None):
                super().tick(name, *tensors, sig=sig)
                Trace.mark(f"portbench.tick.{name}")
        t = TickTimer()
        P.set_phase_timer(t)
        return t

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
        out = getattr(self.runner, call["method"])(
            **{k: value(v) for k, v in args.items()})
        mesh = out["mesh"]
        ok = (mesh is not None and os.path.exists(ctx["out_path"])
              and len(mesh.f) > 0 and mesh.albedo is not None
              and bool(np.isfinite(mesh.albedo).all()))
        return {"ok": ok, "faces": 0 if mesh is None else len(mesh.f)}

    def free(self):
        self.runner = None


    # ------------------------------------------------------------------
    def _ucfg(self):
        u = dict(self.cfg["unet"])
        u["block_out_channels"] = tuple(u["block_out_channels"])
        u["attn_down"] = tuple(u["attn_down"])
        return RD.UNetCfg(**u)

    def _vcfg(self):
        v = dict(self.cfg["vae"])
        v["block_out_channels"] = tuple(v["block_out_channels"])
        return RD.VAECfg(**v)

    def _factory(self, site):
        """(make, method, seed tag) of the reference module a site calls."""
        if site == "unet":
            return (lambda: RD.UNet(self._ucfg(), ip=self.ip), "forward",
                    "UNet2DCondition:0")
        if site.startswith("controlnet_"):
            i = self.kinds.index(site[len("controlnet_"):])
            return (lambda: RD.ControlNet(
                self._ucfg(), self.cfg["controlnet_hint_strides"]),
                "forward", f"ControlNet:{1 + i}")
        if site in ("vae_decode", "vae_encode"):
            return (lambda: RD.VAE(self._vcfg()), site[4:],
                    "AutoencoderKL:0")
        raise KeyError(site)

    def reference_module(self, site):
        make, method, tag = self._factory(site)
        with torch.device(self.device):
            mod = make()
        seed_params_(mod, self.seed, tag, self.device,
                     only=lambda n: not _is_ip(n))
        if site == "unet" and self.ip:
            seed_params_(mod, self.seed, IP_TAG, self.device, only=_is_ip)
        return mod.eval().requires_grad_(False), method

    def model_flops(self, sites):
        """Model FLOPs of every recorded call of the diffusion models in
        the window."""
        total = 0
        for name in DIFFUSION_SITES:
            if name not in sites.sites:
                continue
            make, method, _ = self._factory(name)
            for sig, n in sites.sites[name].sigs.items():
                total += n * call_flops((name, self.tiny), make, method, sig)
        return total

    @torch.no_grad()
    def compare(self, captures, control=False):
        dev, nums = self.device, {}
        with RD.no_tf32():
            for site in DIFFUSION_SITES:
                if site not in captures:
                    continue
                args, kwargs, out = captures[site]
                mod, method = self.reference_module(site)
                args, kwargs = to_device(args, dev), to_device(kwargs, dev)
                ref = getattr(mod, method)(*args, **kwargs)
                low = None
                if control or site in IN_CONTROL_UNITS:
                    for sub in mod.modules():
                        if hasattr(sub, "quant"):
                            sub.quant = RD.Quant(fp8=True)
                    low = getattr(mod, method)(*args, **kwargs)
                if control:
                    out = low
                nums[f"{site}_rel"] = tree_rel(out, ref)
                if site in IN_CONTROL_UNITS:
                    nums[f"{site}_rel_vs_fp8"] = nums[f"{site}_rel"] / max(
                        tree_rel(low, ref), 1e-30)
                del mod, ref
            if "segment_sum" in captures:
                (idx, vals, size), _, out = captures["segment_sum"]
                nums["segment_err"] = segment_error(
                    idx.to(dev), vals.to(dev), size, out.to(dev), control)
            if "raster_select" in captures:
                args, kwargs, out = captures["raster_select"]
                args = list(to_device(args, dev))
                kwargs = to_device(kwargs, dev)
                if control:
                    args[0] = args[0].to(torch.bfloat16).float()
                _, key, face = raster_select_reference(*args, **kwargs)
                bad = (face.cpu() != out[2].long()) | (
                    key.cpu().view(torch.int32) != out[1].view(torch.int32))
                nums["raster_mismatch"] = float(bad.sum())
            for key in ("gather_rows", "gather_rows@render_all"):
                if key in captures:
                    (x, idx), _, out = captures[key]
                    nums[key.replace("gather_rows", "gather_mismatch")] = \
                        gather_mismatch(x.to(dev), idx.to(dev), out.to(dev),
                                        control)
            if "fit_step" in captures:
                nums["fit_step_rel"] = adam_step_error(
                    captures["fit_step"], dev, control)
            nums["fit_steps_missing"] = float(abs(
                captures["calls"].get("fit_step", 0) - self.fit_steps))
            if "bake_texture" in captures:
                args, kw, (rgb, mask) = captures["bake_texture"]
                verts, faces, _, uvs, uv_faces = to_device(args[:5], dev)
                params = to_device(kw.get("field_params", args[7]
                                          if len(args) > 7 else None), dev)
                acfg = args[6] if len(args) > 6 else kw["cfg"]
                (nums["bake_coverage"], nums["bake_rel"]) = bake_numbers(
                    verts, faces, uvs, uv_faces, acfg["height"],
                    acfg["width"], params, self.cfg["field"], rgb.to(dev),
                    mask.to(dev), control)
            if "edge_dilation" in captures:
                args, kw, out = captures["edge_dilation"]
                img, mask = to_device(args[:2], dev)
                n = kw.get("n_iters", args[2] if len(args) > 2 else 16)
                nums["dilation_rel"] = dilation_rel(img, mask, n,
                                                    out.to(dev), control)
        return nums


class AdamSnap:
    """The capture of one `torch.optim.Adam.step`, which works in place:
    before it, each parameter with its gradient, moments, step count and
    its group's hyper-parameters; after it, the new parameters."""

    @staticmethod
    def before(args, kwargs):
        opt, leaves = args[0], []
        for group in opt.param_groups:
            hyper = dict(lr=float(group["lr"]), betas=tuple(
                float(b) for b in group["betas"]), eps=float(group["eps"]),
                weight_decay=float(group.get("weight_decay", 0.0)))
            for p in group["params"]:
                st = opt.state.get(p, {})
                leaves.append(dict(
                    hyper, p=to_host(p), g=to_host(p.grad),
                    m=to_host(st.get("exp_avg")),
                    v=to_host(st.get("exp_avg_sq")),
                    step=float(st["step"]) if "step" in st else 0.0))
        return leaves

    @staticmethod
    def after(args, kwargs, out, pre):
        new = [to_host(p) for group in args[0].param_groups
               for p in group["params"]]
        return [dict(leaf, new=p) for leaf, p in zip(pre, new)]
