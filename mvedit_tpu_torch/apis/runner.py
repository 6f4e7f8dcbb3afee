"""Adapter3DRunner: the model zoo and the public endpoints.

Counterpart of `mvedit_tpu/apis/runner.py`, for the parts `run_3d_to_3d`,
`run_retex`, texture superres, `run_mesh_to_video`, `run_text_to_img`,
image-to-3D and text-to-3D need: the SD1.5 UNet, VAE and CLIP text
encoder, the SSDNeRF denoiser and triplane decoder, the tile and
depth (and ip2p, and Zero123++ v1.2's normal) ControlNets, LPIPS, the
SRVGG image enhancer, IP-Adapter with its CLIP vision tower, the
perception nets (TRACER-B7 masks with SAM's box-prompted refinement, DPT
normals, LoFTR matches for the input view's pose), prompt encoding, the
mesh preprocessing, and the rig constants (`constants`, with
`apis/cameras.py` and `utils/camera.py`).

Models are built on `device` with seeded random weights (drawn from a
`torch.Generator`), then loaded from `checkpoint_dir` where it holds them,
in the reference's search order: `<checkpoint_dir>/<subdir>/` with
`diffusion_pytorch_model.{safetensors,bin}`, `model.safetensors`,
`pytorch_model.bin` or `<subdir>.safetensors`, for the subdirs `unet`,
`vae`, `text_encoder`, `controlnet_{tile,depth,ip2p,z123_normal}`,
`image_enhancer`, `ip_adapter_vision`, `zero123plus_vision`,
`zero123plus_normal_unet`, `tracer`, `omnidata`, `loftr` and `sam` (those
four in their reference checkpoints' own key layouts);
LPIPS from `lpips/lpips_vgg.{safetensors,bin}`; the IP-Adapter
projection and UNet branches from `ip_adapter/ip_adapter.npz` (the
reference's converted flax tree). The
files' keys are diffusers' / transformers' (SRVGG: Real-ESRGAN's), so they
go in with `load_state_dict`; keys that match nothing are reported, and
parameters a file lacks keep their seeded values. `checkpoint_dir` may be
a `huggingface://org/repo` reference into the local cache. Full-size
models store bf16 weights, as the reference casts them; the f32 layers
compute in f32 all the same; SAM stays f32, as the reference runs it.
"""
import os
import types

import numpy as np
import torch

from ..models.diffusion import (SD15_TEXT, SD15_UNET, SD_VAE, AutoencoderKL,
                                CLIPTextConfig, CLIPTextModel, ControlNet,
                                UNet2DCondition, UNetConfig, VAEConfig,
                                schedulers as S)
from ..models.diffusion.tokenizer import CLIPTokenizer, HashTokenizer
from ..models.diffusion.weights import load_torch_state
from ..models.mesh import Mesh
from . import cameras as C
from .endpoints import EndpointsMixin

__all__ = ["Adapter3DRunner", "init_random_"]

# parameters a fresh flax model initialises to zero (controlnet.py:64,100,
# 104; clip.py:109)
_ZERO_INIT = ("controlnet_cond_embedding.conv_out.",
              "controlnet_down_blocks.", "controlnet_mid_block.",
              "embeddings.position_embedding.", "embeddings.class_embedding")
# the files of a model's subdir, in the reference's search order
_CHECKPOINT_FILES = ("diffusion_pytorch_model.safetensors",
                     "diffusion_pytorch_model.bin", "model.safetensors",
                     "pytorch_model.bin")


@torch.no_grad()
def init_random_(module, generator):
    """Seeded init in place, after flax's defaults: weights of rank >= 2
    N(0, 1/fan_in), biases 0, norm weights 1, zero-initialised heads 0."""
    for name, p in module.named_parameters():
        if any(z in name for z in _ZERO_INIT) or name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=p.dtype)
                    * fan_in ** -0.5)
    return module


class Adapter3DRunner(EndpointsMixin):
    def __init__(self, checkpoint_dir=None, seed=42, tiny_models=False,
                 device="cuda"):
        if checkpoint_dir is not None:
            from ..utils.hub import resolve_checkpoint
            checkpoint_dir = resolve_checkpoint(checkpoint_dir)
        self.checkpoint_dir = checkpoint_dir
        self.seed = seed
        self.tiny = tiny_models
        self.device = torch.device(device)
        self.constants = C.CONSTANTS
        self._cache = {}
        tok_dir = checkpoint_dir and os.path.join(checkpoint_dir, "tokenizer")
        if tok_dir and os.path.exists(os.path.join(tok_dir, "vocab.json")):
            self.tokenizer = CLIPTokenizer(
                os.path.join(tok_dir, "vocab.json"),
                os.path.join(tok_dir, "merges.txt"))
        else:
            self.tokenizer = HashTokenizer()

    def _tiny_unet_cfg(self):
        return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                          attn_down=(True, False), cross_attention_dim=32,
                          num_heads=4, dtype=torch.float32)

    def _checkpoint_file(self, subdir):
        """The first checkpoint file of `checkpoint_dir/subdir/`, or None."""
        if not (self.checkpoint_dir and subdir):
            return None
        for fname in _CHECKPOINT_FILES + (f"{subdir}.safetensors",):
            path = os.path.join(self.checkpoint_dir, subdir, fname)
            if os.path.exists(path):
                return path
        return None

    @staticmethod
    def _load_into(name, model, state, convert=None):
        """`load_state_dict` of a checkpoint's state (through `convert`,
        which returns (state, unmatched keys)); reports the keys that match
        no parameter and the parameters the state lacks."""
        unmatched = []
        if convert is not None:
            state, unmatched = convert(state)
        state = {k: v for k, v in state.items() if "position_ids" not in k}
        missing, unexpected = model.load_state_dict(state, strict=False)
        unmatched = list(unmatched) + list(unexpected)
        if unmatched:
            print(f"[runner] {name}: {len(unmatched)} unconverted keys, "
                  f"e.g. {unmatched[:4]}")
        if missing:
            print(f"[runner] {name}: {len(missing)} parameters keep their "
                  f"seeded values, e.g. {list(missing)[:4]}")

    def _build(self, name, make, seed_offset=0, subdir=None, convert=None,
               post_init=None, cast=True):
        """Builds, seeds, loads from `checkpoint_dir/subdir` where a file is
        found, and (full size, with `cast`) casts a model to bf16, once per
        name. `post_init(model, generator)` adjusts the seeded values
        before the load."""
        if name in self._cache:
            return self._cache[name]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + seed_offset)
        with torch.device(self.device):
            model = make()
        init_random_(model, gen)
        if post_init is not None:
            post_init(model, gen)
        path = self._checkpoint_file(subdir)
        if path is not None:
            self._load_into(name, model, load_torch_state(path), convert)
        if cast and not self.tiny:
            # inference-only frozen nets store bf16 weights (runner.py:96-107)
            model = model.to(torch.bfloat16)
        model.eval().requires_grad_(False)
        self._cache[name] = model
        return model

    def load_stable_diffusion(self, checkpoint="sd15"):
        if self.tiny:
            cfg = self._tiny_unet_cfg()
            vae_cfg = VAEConfig(block_out_channels=(32, 64),
                                layers_per_block=1, dtype=torch.float32)
            text_cfg = CLIPTextConfig(vocab_size=49408, hidden_size=32,
                                      intermediate_size=64, num_layers=2,
                                      num_heads=4)
        else:
            cfg, vae_cfg, text_cfg = SD15_UNET, SD_VAE, SD15_TEXT
        m = types.SimpleNamespace()
        m.unet = self._build(f"unet:{checkpoint}",
                             lambda: UNet2DCondition(cfg), subdir="unet")
        m.vae = self._build(f"vae:{checkpoint}",
                            lambda: AutoencoderKL(vae_cfg), subdir="vae")
        m.text = self._build(f"text:{checkpoint}",
                             lambda: CLIPTextModel(text_cfg),
                             subdir="text_encoder")
        m.schedule = S.sd_schedule()
        m.text_cfg = text_cfg
        return m

    def load_controlnets(self, kinds=("tile", "depth")):
        cfg = self._tiny_unet_cfg() if self.tiny else SD15_UNET
        # the tiny VAE downsamples /2 (2 blocks) against SD's /8
        hint_strides = 1 if self.tiny else 3
        return tuple(
            self._build(f"controlnet:{kind}",
                        lambda: ControlNet(cfg, hint_strides=hint_strides),
                        seed_offset=1 + i, subdir=f"controlnet_{kind}")
            for i, kind in enumerate(kinds))

    def load_ssdnerf(self):
        """The text-to-3D models, once per runner: the SSDNeRF cars
        configuration (`configs/ssdnerf_cars.py`), its `LatentDenoiser` at
        the published widths (seeded with `seed + 11`, f32), the triplane
        decoder's params (`triplane_init` from a generator seeded with
        `seed`) and the v-prediction schedule. The reference builds the
        denoiser anew from each request's seed; no converter of its
        checkpoint exists yet, so both stay seeded."""
        if "ssdnerf" not in self._cache:
            from ..configs.ssdnerf_cars import LatentDenoiser, ssdnerf_config
            from ..models.triplane import triplane_init
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed)
            self._cache["ssdnerf"] = types.SimpleNamespace(
                cfg=ssdnerf_config,
                denoiser=self._build("ssdnerf_denoiser", LatentDenoiser,
                                     seed_offset=11, cast=False),
                decoder=triplane_init(ssdnerf_config.triplane, gen,
                                      self.device),
                schedule=S.sd_schedule(prediction_type="v_prediction"))
        return self._cache["ssdnerf"]

    @torch.inference_mode()
    def encode_prompt(self, m, prompts, negative_prompts):
        """(pos (N, L, C), neg (N, L, C)) text embeddings."""
        def enc(texts):
            ids = torch.as_tensor(self.tokenizer(texts), device=self.device)
            return m.text(ids.long())
        return enc(prompts), enc(negative_prompts)

    def load_lpips(self):
        """LPIPS params for the fits' patch losses: None with tiny models
        (the pipelines then run without LPIPS), else VGG16 at its published
        widths, from `lpips/lpips_vgg.{safetensors,bin}` (torchvision's
        VGG16 `features` keys and the lpips heads as `linK` or the lpips
        package's `linK.model.1.weight`) or seeded, stored bf16 (the
        reference's cast)."""
        if self.tiny:
            return None
        if "lpips" not in self._cache:
            from ..models.losses import lpips_init, lpips_params_from_torch
            path = None
            if self.checkpoint_dir:
                for fname in ("lpips_vgg.safetensors", "lpips_vgg.bin"):
                    p = os.path.join(self.checkpoint_dir, "lpips", fname)
                    if os.path.exists(p):
                        path = p
                        break
            if path is not None:
                sd = load_torch_state(path)
                if "lin0" in sd:
                    lins = [sd[f"lin{i}"] for i in range(5)]
                else:
                    lins = [sd[f"lin{i}.model.1.weight"] for i in range(5)]
                params = lpips_params_from_torch(sd, lins, self.device)
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.seed)
                params = lpips_init(gen, self.device)
            self._cache["lpips"] = {
                "convs": [{k: v.to(torch.bfloat16) for k, v in c.items()}
                          for c in params["convs"]],
                "lins": [v.to(torch.bfloat16) for v in params["lins"]]}
        return self._cache["lpips"]

    def load_image_enhancer(self):
        """The SRVGG x4 enhancer as the pipeline's `enhance_fn(images,
        size)`: (N, h, w, 3) renders -> (N, size, size, 3) in [0, 1]."""
        if "enhance_fn" in self._cache:
            return self._cache["enhance_fn"]
        from ..models.image_enhancer import SRVGGNetCompact
        from ..ops.image import resize_bilinear

        @torch.no_grad()
        def prelu_init(net, gen):        # PReLU slopes start at 0.25
            for mod in net.body:
                if isinstance(mod, torch.nn.PReLU):
                    mod.weight.fill_(0.25)

        def unwrap(sd):
            # Real-ESRGAN's .pth files keep the weights under "params_ema"
            # or "params"
            return sd.get("params_ema", sd.get("params", sd)), []
        net = self._build("srvgg", lambda: SRVGGNetCompact(
            num_feat=8 if self.tiny else 64, num_conv=2 if self.tiny else 32),
            subdir="image_enhancer", convert=unwrap, post_init=prelu_init)

        @torch.inference_mode()
        def enhance_fn(images, size):
            up = net(images.clamp(0.0, 1.0))
            if up.shape[1] != size:
                up = resize_bilinear(up, (size, size))
            return up.clamp(0.0, 1.0).clone()

        self._cache["enhance_fn"] = enhance_fn
        return enhance_fn

    def enable_ip_adapter(self, m, image, num_tokens=4):
        """Image-prompt conditioning (the reference's `enable_ip_adapter`):

        1. the CLIP vision tower encodes `image` (resized to its input
           size with the reference's antialiased bilinear, CLIP-normalised)
           into one embed;
        2. `ImageProjModel` turns it into `num_tokens` context tokens, and
           the zero embed into the uncond tokens;
        3. every UNet cross-attention gets its `ip_to_k` / `ip_to_v`
           branch (`add_ip_branches`).

        Weights come from `ip_adapter_vision/` and `ip_adapter/
        ip_adapter.npz` in `checkpoint_dir`, else seeded with `seed + 7`.
        The tower has `CLIPVisionConfig()`'s widths, as the reference's
        runner builds it (not `IPADAPTER_VISION`'s ViT-H). Sets
        `m.ip_encode_fn` (images (N, H, W, 3) in [0, 1] -> (2N, T, C)
        [uncond; cond] tokens) and `m.ip_context` (2, T, C), which the
        pipelines read, and returns the latter."""
        from ..models.diffusion.clip import CLIPVisionConfig, CLIPVisionModel
        from ..models.diffusion.ip_adapter import (ImageProjModel,
                                                   add_ip_branches)
        from ..models.diffusion.weights import (convert_clip_vision,
                                                torch_state_from_flax)
        from ..ops.image import resize_bilinear
        dev = self.device
        if self.tiny:
            vcfg = CLIPVisionConfig(image_size=32, patch_size=8,
                                    hidden_size=32, intermediate_size=64,
                                    num_layers=2, num_heads=4,
                                    projection_dim=32)
        else:
            vcfg = CLIPVisionConfig()
        vision = self._build("ip_vision", lambda: CLIPVisionModel(vcfg),
                             seed_offset=7, subdir="ip_adapter_vision",
                             convert=convert_clip_vision)
        ctx_dim = m.text_cfg.hidden_size
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 7)
        with torch.device(dev):
            proj = init_random_(ImageProjModel(ctx_dim, vcfg.projection_dim,
                                               num_tokens), gen)
        proj.eval().requires_grad_(False)
        new = set(add_ip_branches(m.unet))
        with torch.no_grad():
            for name, p in m.unet.named_parameters():
                if name in new:
                    p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                        dtype=p.dtype) * p.shape[1] ** -0.5)
        m.unet.requires_grad_(False)
        path = self.checkpoint_dir and os.path.join(
            self.checkpoint_dir, "ip_adapter", "ip_adapter.npz")
        if path and os.path.exists(path):
            with np.load(path) as d:
                flat = {k: d[k] for k in d.files}
            tree = {}
            for k, v in flat.items():
                node = tree
                *parents, leaf = k.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = v
            self._load_into("ip_proj", proj, torch_state_from_flax(
                tree["image_proj"], "image_proj"))
            ip_state = torch_state_from_flax(tree["unet_patch"], "unet")
            _, unexpected = m.unet.load_state_dict(ip_state, strict=False)
            if unexpected:
                print(f"[runner] ip_adapter: {len(unexpected)} unconverted "
                      f"keys, e.g. {list(unexpected)[:4]}")
        mean = torch.tensor([0.4815, 0.4578, 0.4082], device=dev)
        std = torch.tensor([0.2686, 0.2613, 0.2758], device=dev)

        @torch.inference_mode()
        def ip_encode_fn(images):
            ims = torch.as_tensor(np.asarray(images, np.float32)
                                  if not torch.is_tensor(images) else images,
                                  dtype=torch.float32, device=dev)
            if ims.dim() == 3:
                ims = ims[None]
            ims = resize_bilinear(ims, (vcfg.image_size, vcfg.image_size))
            emb = vision((ims - mean) / std).float()
            tok_c = proj(emb)
            tok_u = proj(torch.zeros_like(emb))
            return torch.cat([tok_u, tok_c], 0).clone()

        m.ip_encode_fn = ip_encode_fn
        m.ip_context = ip_encode_fn(image)
        return m.ip_context

    # ---- perception nets of image-to-3D -------------------------------

    def load_tracer(self, seed=None):
        """TRACER-B7 (`tracer/` in `checkpoint_dir`, else seeded with
        `seed`, by default the runner's)."""
        from ..models.segmentors import TracerDecoder, convert_tracer_state
        return self._build("tracer", TracerDecoder,
                           seed_offset=0 if seed is None else seed - self.seed,
                           subdir="tracer", convert=convert_tracer_state)

    def make_segment_fn(self):
        """The MVEdit loop's per-step hook: (N, H, W, 3) decoded views in
        [0, 1] -> (N, H, W, 1) TRACER masks at 640^2 (64^2 tiny), eight
        views per net call."""
        from ..models.segmentors import tracer_segment
        net = self.load_tracer()
        size = 64 if self.tiny else 640

        @torch.inference_mode()
        def segment_fn(images):
            return tracer_segment(net, images, input_size=size, chunk=8)
        return segment_fn

    def run_segmentation(self, images, seed=42, refine_fn=None,
                         use_sam=False, bg_color=None, erosion=0):
        """TRACER foreground masks: images (N, H, W, 3) in [0, 1] (numpy
        or a tensor) -> (N, H, W, 1) on the runner's device. `refine_fn`
        (`preproc.do_segmentation`'s box-prompted refiner; `use_sam`
        installs `make_sam_refine_fn()`), `bg_color` and `erosion` go
        through `preproc.do_segmentation`, as the reference's."""
        from ..models.segmentors import tracer_segment
        net = self.load_tracer(seed=seed)
        ims = torch.as_tensor(np.asarray(images, np.float32)
                              if not torch.is_tensor(images) else images,
                              dtype=torch.float32, device=self.device)

        @torch.inference_mode()
        def segment(x):
            return tracer_segment(net, x, 64 if self.tiny else 640, chunk=8)
        if use_sam and refine_fn is None:
            refine_fn = self.make_sam_refine_fn()
        if refine_fn is None and bg_color is None and erosion == 0:
            return segment(ims)
        from ..pipelines.preproc import do_segmentation
        return do_segmentation(ims, segment, refine_fn=refine_fn,
                               bg_color=bg_color, erosion=erosion)

    def load_sam(self):
        """SAM in float32: ViT-H (`SAM_TINY` with tiny models) from
        `sam/` in `checkpoint_dir` (segment-anything's
        `sam_vit_h_4b8939.pth` keys), else seeded; its positional-encoding
        matrix N(0, 1), as segment-anything draws it."""
        from ..models.segmentors.sam import SAM_TINY, SAM_VIT_H, SamModel
        cfg = SAM_TINY if self.tiny else SAM_VIT_H

        @torch.no_grad()
        def pe_init(net, gen):
            g = net.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
            g.copy_(torch.randn(g.shape, generator=gen, device=g.device))
        return self._build("sam", lambda: SamModel(cfg), seed_offset=9,
                           subdir="sam", post_init=pe_init, cast=False)

    def make_sam_refine_fn(self):
        """`refine_fn(image_uint8 (H, W, 3), bbox (4,) xyxy) -> (H, W)`
        float32 numpy mask, through SAM on the runner's device."""
        from ..models.segmentors.sam import sam_predict_box
        model = self.load_sam()

        def refine(image_uint8, bbox):
            img = torch.as_tensor(np.asarray(image_uint8, np.float32) / 255.0,
                                  device=self.device)
            return sam_predict_box(model, img, bbox).cpu().numpy()
        return refine

    def load_normal_model(self):
        """Omnidata's DPT-hybrid (`omnidata/` in `checkpoint_dir`, else
        seeded) and its input size: (net, 384), tiny (net, 32)."""
        from ..models.segmentors import DPTNormalModel, convert_dpt_state
        if self.tiny:
            net = self._build("dpt", lambda: DPTNormalModel(
                vit_layers=2, readout_taps=(0, 1), resnet_layers=(1, 1, 1)),
                subdir="omnidata", convert=convert_dpt_state)
            return net, 32
        return self._build("dpt", DPTNormalModel, subdir="omnidata",
                           convert=convert_dpt_state), 384

    @torch.inference_mode()
    def predict_normals(self, images):
        """(N, H, W, 3) in [0, 1] -> (N, H, W, 3) normal maps in [0, 1]:
        the net at its input size (resized with the reference's
        antialiased bilinear), clamped, resized back."""
        from ..ops.image import resize_bilinear
        net, s = self.load_normal_model()
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        h, w = x.shape[1:3]
        out = net(resize_bilinear(x, (s, s))).clamp(0.0, 1.0)
        return resize_bilinear(out, (h, w))

    def load_matcher(self):
        """LoFTR with 4 coarse layer pairs (1 tiny), `loftr/` in
        `checkpoint_dir`, else seeded."""
        from ..models.segmentors import LoFTR, convert_loftr_state
        return self._build("loftr",
                           lambda: LoFTR(layers=1 if self.tiny else 4),
                           subdir="loftr", convert=convert_loftr_state)

    def estimate_input_pose(self, image, views, view_poses, fov):
        """The input image's elevation against generated views of known
        pose: LoFTR matches at 256^2 (32^2 tiny) of the grey images, then
        `elev_estimation`. Returns ((3, 4) pose at azimuth 0 and the
        views' mean distance, elevation), or (None, 0.0) when the views
        give fewer than 8 matches (the caller then takes the front
        pose)."""
        import math
        from ..models.segmentors import match_images
        from ..ops.image import resize_bilinear
        from ..utils.pose_estimation import elev_estimation
        net = self.load_matcher()
        s = 32 if self.tiny else 256

        def prep(im):
            g = torch.as_tensor(np.asarray(im, np.float32),
                                device=self.device).mean(-1, keepdim=True)
            return resize_bilinear(g, (s, s))[None]
        img0 = prep(image)
        matches = [match_images(net, img0, prep(v)) for v in views]
        self.last_match_count = sum(len(m[0]) for m in matches)
        if self.last_match_count < 8:
            return None, 0.0
        focal = s / (2 * math.tan(math.radians(fov / 2)))
        intr = np.asarray([focal, focal, s / 2, s / 2], np.float32)
        elev, pose = elev_estimation(matches, np.asarray(view_poses), intr)
        return np.asarray(pose)[:3], elev

    def run_retex(self, mesh_path, prompt, negative_prompt="", seed=42,
                  steps=12, denoising_strength=0.7, cfg_scale=None,
                  num_views=None, render_size=None, n_inverse_steps=24,
                  instruct=False, front_view_id=None, in_image=None,
                  out_path=None, draws=None, **kwargs):
        """Re-texturing (the reference's `run_retex` -> `TexturePipeline`).
        instruct=True adds the ip2p ControlNet on the source renders;
        front_view_id (an index into the preprocessing turntable) starts
        the rig at its azimuth, weights the views by a von Mises pdf (3.0
        on the front view), inserts a top view at index 1 and gives each
        view its direction prompt; in_image (H, W, 3) in [0, 1] prompts
        through IP-Adapter. Extra kwargs follow `apis/parameters.py::
        retex_defaults`. The random draws come from a generator seeded
        with `seed`, or from `draws` (`pipelines.GeneratorDraws`' methods).
        `superres` (True or a dict of `proc_texture_superres` overrides)
        chains texture superres on the live albedo field."""
        from ..models.fields import INGPConfig
        from ..ops.dense_grid import DenseGridConfig
        from ..pipelines.texture import TextureConfig, TexturePipeline
        from ..utils import camera as cam_utils
        from . import parameters as P
        nk = dict(P.retex_defaults)
        if instruct:
            nk.update(P.instruct_retex_params)
        for k, v in kwargs.items():
            if k in nk and v is not None:
                nk[k] = v
        prompt = ", ".join(p for p in (prompt, nk["aux_prompt"]) if p)
        negative_prompt = ", ".join(
            p for p in (negative_prompt, nk["aux_negative_prompt"]) if p)
        dev = self.device
        m = self.load_stable_diffusion()
        m.controlnets = self.load_controlnets(
            ("tile", "depth", "ip2p") if instruct else ("tile", "depth"))
        m.lpips_params = self.load_lpips()
        if in_image is not None:
            self.enable_ip_adapter(m, in_image)
        else:
            m.ip_context = None
        num_views = num_views or (4 if self.tiny else 12)
        render_size = render_size or (64 if self.tiny else 512)
        c = self.constants
        rng = np.random.default_rng(seed)
        front_azi = cam_weights = None
        if front_view_id is not None and \
                0 <= front_view_id < c["preproc_num_views"]:
            front_azi = front_view_id / c["preproc_num_views"] * 2 * np.pi
        poses, intr = C.surround_rig(
            num_views, c["proc_3d_to_3d_camera_distance"],
            c["proc_3d_to_3d_fov"], c["proc_retex_min_elev"],
            c["proc_retex_max_elev"], render_size,
            begin_rad=front_azi or 0.0, rng=rng)
        prompts = [prompt] * num_views
        if front_azi is not None:
            from scipy.stats import vonmises
            cam_azi = np.arctan2(poses[:, 1, 3], poses[:, 0, 3])
            cam_weights = vonmises.pdf(
                cam_azi, loc=front_azi,
                kappa=c["vonmises_kappa"]) * (2 * np.pi)
            cam_weights[0] = 3.0
            # a top view (elevation 0.6 rad) at index 1, weight 1.0, so that
            # keep_first_views=2 keeps the front and the top view
            aux_pose = cam_utils.get_pose_from_angles(
                np.array([front_azi], np.float32),
                np.array([0.6], np.float32),
                np.array([c["proc_3d_to_3d_camera_distance"]],
                         np.float32))[:, :3]
            poses = np.concatenate([poses[:1], aux_pose, poses[1:]], 0)
            intr = np.concatenate([intr, intr[:1]], 0)
            suffixes = cam_utils.view_prompts(
                np.concatenate([poses[:1], poses[2:]], 0), front_azi)
            suffixes = [suffixes[0], "view from above"] + suffixes[1:]
            cam_weights = np.concatenate(
                [cam_weights[:1], [1.0], cam_weights[1:]]).astype(np.float32)
            prompts = [", ".join(p for p in (prompt, s_) if p)
                       for s_ in suffixes]
            num_views = num_views + 1
        ingp = INGPConfig(backend="dense", dense=DenseGridConfig(
            resolutions=(8, 32) if self.tiny else (32, 160)))
        cfg = TextureConfig(
            num_views=num_views, render_size=render_size,
            diffusion_steps=steps, denoising_strength=denoising_strength,
            guidance_scale=float(cfg_scale if cfg_scale is not None
                                 else nk["cfg_scale"]),
            n_inverse_steps=n_inverse_steps, lr=float(nk["lr"]),
            views_per_step=int(nk["render_bs"]),
            min_num_views=min(int(nk["min_num_views"]), num_views),
            keep_first_views=2 if front_azi is not None else 0,
            mode=nk["mvedit_mode"], ingp=ingp)
        mesh = self.run_mesh_preproc(mesh_path)["mesh"]
        pos_e, neg_e = self.encode_prompt(m, prompts,
                                          [negative_prompt] * num_views)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        out = TexturePipeline(m, cfg)(
            mesh, t(poses), t(intr), pos_e.clone(), neg_e.clone(),
            generator=gen, draws=draws, cam_weights=cam_weights)
        out = self._chain_superres(out, "field_params", prompt,
                                   negative_prompt, seed,
                                   kwargs.get("superres", False))
        if out_path:
            out["mesh"].write(out_path, flip_yz=True)
        return out

    @torch.no_grad()
    def run_mesh_to_video(self, mesh_path, out_path="out.mp4",
                          num_frames=60, render_size=None, elev=0.2,
                          distance=3.0, fov=40.0, seed=42):
        """An orbit video of a mesh file: each frame rendered on the
        runner's device, coloured from the albedo through per-vertex uvs
        (else by its normals), on white; written by `utils.video.
        write_video` (mp4 through ffmpeg where it is installed, else a
        GIF). Returns the written path."""
        from ..models.mesh import RasterConfig, render_views
        from ..models.mesh.texture import _sample_level
        from ..utils import camera as cam_utils
        from ..utils.video import render_surround_video
        dev = self.device
        render_size = render_size or (64 if self.tiny else 512)
        mesh = Mesh.load(mesh_path)
        rc = RasterConfig(height=render_size, width=render_size)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        verts, faces = t(mesh.v), t(mesh.f, torch.int64)
        fmask = torch.ones(faces.shape[0], dtype=torch.bool, device=dev)
        tex = None if mesh.albedo is None else t(mesh.albedo)
        # the albedo is sampled through per-vertex uvs only
        uv_attr = t(mesh.vt) if tex is not None and mesh.vt is not None \
            and len(mesh.vt) == len(mesh.v) else None
        intr = cam_utils.intrinsics_from_fov(fov, render_size, render_size)
        pose0 = cam_utils.get_pose_from_angles(
            np.array([0.0]), np.array([elev]), distance)[0]

        def render_frame(pose, intrinsics):
            out = render_views(verts, faces, fmask, t(pose)[None],
                               t(intrinsics)[None], rc,
                               vert_attrs=None if uv_attr is None
                               else {"uv": uv_attr})
            a = out["alpha"][0]
            rgb = out["normal"][0] * 0.5 + 0.5 if uv_attr is None \
                else _sample_level(tex, out["uv"][0])
            return (rgb * a + (1 - a)).clamp(0.0, 1.0).cpu().numpy()

        return render_surround_video(render_frame, pose0, intr,
                                     num_frames=num_frames, path=out_path)

    def run_mesh_preproc(self, mesh_path, out_path=None):
        """Load and normalise an input mesh: multi-material GLB scenes
        merge into one atlas-packed mesh, vertex colours become a texture,
        the mesh is scaled into a sphere of radius 0.9."""
        mesh_path = str(mesh_path)
        if mesh_path.endswith((".glb", ".gltf")):
            parts = Mesh.load_glb_parts(mesh_path)
            if len(parts) > 1:
                from ..models.mesh.atlas import merge_meshes
                mesh = merge_meshes(parts)
            else:
                mesh = parts[0]
        else:
            mesh = Mesh.load(mesh_path)
        center, scale = mesh.auto_size(0.9)
        if mesh.vn is None:
            mesh.auto_normal()
        if mesh.vt is None:
            mesh.auto_uv()
        if mesh.albedo is None and mesh.vc is not None:
            mesh.albedo = self._vc_to_texture(mesh)
        if out_path:
            mesh.write(out_path)
        return {"mesh": mesh, "center": center, "scale": scale}

    @staticmethod
    def _vc_to_texture(mesh, size=512):
        """Vertex colours -> a UV texture: nearest UV vertex per texel, then
        edge dilation."""
        from scipy.spatial import cKDTree
        from ..ops.image import edge_dilation
        vt = np.asarray(mesh.vt)
        ft = np.asarray(mesh.ft if mesh.ft is not None else mesh.f)
        f = np.asarray(mesh.f)
        vc = np.asarray(mesh.vc, np.float32)
        # a UV vertex takes the colour of the mesh vertex of its face corner
        uv_color = np.zeros((len(vt), 3), np.float32)
        uv_color[ft.reshape(-1)] = vc[f.reshape(-1)]
        yy, xx = np.mgrid[0:size, 0:size]
        pix_uv = np.stack([(xx + 0.5) / size, (yy + 0.5) / size],
                          axis=-1).reshape(-1, 2)
        dist, idx = cKDTree(vt).query(pix_uv)
        tex = uv_color[idx].reshape(size, size, 3)
        near = (dist < 4.0 / size).reshape(size, size).astype(np.float32)
        tex = edge_dilation(torch.from_numpy(tex), torch.from_numpy(near),
                            n_iters=16).numpy()
        return np.clip(tex, 0.0, 1.0)
