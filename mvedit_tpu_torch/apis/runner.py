"""Adapter3DRunner: the model zoo and the public endpoints.

Counterpart of `mvedit_tpu/apis/runner.py`, for the parts `run_3d_to_3d`
and `run_text_to_img` need: the SD1.5 UNet, VAE and CLIP text encoder, the
tile and depth (and ip2p) ControlNets, LPIPS, the SRVGG image enhancer,
prompt encoding, the mesh preprocessing, and the rig constants (`constants`,
with `apis/cameras.py` and `utils/camera.py`). Models are built on `device`
with seeded random weights (drawn from a `torch.Generator`; loading
checkpoints from `checkpoint_dir` is not ported yet). Full-size models
store bf16 weights, as the reference casts them; the f32 layers compute in
f32 all the same.
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
from ..models.mesh import Mesh
from . import cameras as C
from .endpoints import EndpointsMixin

__all__ = ["Adapter3DRunner", "init_random_"]

# parameters a fresh flax model initialises to zero (controlnet.py:64,100,
# 104; clip.py:109)
_ZERO_INIT = ("controlnet_cond_embedding.conv_out.",
              "controlnet_down_blocks.", "controlnet_mid_block.",
              "embeddings.position_embedding.")


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

    def _build(self, name, make, seed_offset=0):
        """Builds, seeds and (full size) casts a model once per name."""
        if name in self._cache:
            return self._cache[name]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + seed_offset)
        with torch.device(self.device):
            model = make()
        init_random_(model, gen)
        if not self.tiny:
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
                             lambda: UNet2DCondition(cfg))
        m.vae = self._build(f"vae:{checkpoint}",
                            lambda: AutoencoderKL(vae_cfg))
        m.text = self._build(f"text:{checkpoint}",
                             lambda: CLIPTextModel(text_cfg))
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
                        seed_offset=1 + i)
            for i, kind in enumerate(kinds))

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
        widths, seeded, bf16 (the reference's cast)."""
        if self.tiny:
            return None
        if "lpips" not in self._cache:
            from ..models.losses import lpips_init
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
        net = self._build("srvgg", lambda: SRVGGNetCompact(
            num_feat=8 if self.tiny else 64, num_conv=2 if self.tiny else 32))
        with torch.no_grad():
            for mod in net.body:         # PReLU slopes start at 0.25
                if isinstance(mod, torch.nn.PReLU):
                    mod.weight.fill_(0.25)

        @torch.inference_mode()
        def enhance_fn(images, size):
            up = net(images.clamp(0.0, 1.0))
            if up.shape[1] != size:
                up = resize_bilinear(up, (size, size))
            return up.clamp(0.0, 1.0).clone()

        self._cache["enhance_fn"] = enhance_fn
        return enhance_fn

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
