"""Seeded tiny checkpoints for the parity tests of checkpoint loading and of
`run_retex`: the JAX package's tiny models, initialised from a seed and
jittered with seeded noise (so that no bias or norm is trivially 0 or 1),
written the way real checkpoints come, in the port's keys (diffusers',
transformers' and Real-ESRGAN's), as `.safetensors` (the installed
`safetensors` package) or `.bin` (`torch.save`), into a `checkpoint_dir`
that both packages' runners read.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from safetensors.torch import save_file

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.diffusion import AttnMode, UNet2DCondition
from mvedit_tpu.models.diffusion.clip import (CLIPVisionConfig,
                                              CLIPVisionModel)
from mvedit_tpu.models.diffusion.ip_adapter import ImageProjModel
from mvedit_tpu.models.image_enhancer import SRVGGNetCompact

from mvedit_tpu_torch.models.diffusion.weights import (flatten,
                                                       torch_state_from_flax)
from mvedit_tpu_torch.models.image_enhancer import srvgg_state_from_flax

# the runners' tiny IP-Adapter vision tower (`enable_ip_adapter`)
TINY_VISION = dict(image_size=32, patch_size=8, hidden_size=32,
                   intermediate_size=64, num_layers=2, num_heads=4,
                   projection_dim=32)


def jitter(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + scale * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)


def _write(path, state, fmt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {k: v.contiguous() for k, v in state.items()}
    if fmt == "safetensors":
        save_file(state, path)
    else:
        torch.save(state, path)


def write_tiny_checkpoint(root, fmt="safetensors", seed=3):
    """Writes the tiny SD stack (unet, vae, text_encoder), three ControlNets
    (tile, depth, ip2p), the SRVGG enhancer, the IP-Adapter vision tower
    and `ip_adapter/ip_adapter.npz` under `root`, each subdir under another
    of the names the runners search. Returns the flax trees written
    (SRVGG's as the JAX module's own params)."""
    jr = JRunner(seed=seed, tiny_models=True)
    m = jr.load_stable_diffusion()
    _, cn_params = jr.load_controlnets(("tile", "depth", "ip2p"))
    trees = {"unet": jitter(m.unet_params, seed),
             "vae": jitter(m.vae_params, seed + 1),
             "clip_text": jitter(m.text_params, seed + 2)}
    for i, kind in enumerate(("tile", "depth", "ip2p")):
        trees[f"controlnet_{kind}"] = jitter(cn_params[i], seed + 3 + i)
    ext = fmt
    names = {"unet": f"unet/diffusion_pytorch_model.{ext}",
             "vae": f"vae/diffusion_pytorch_model.{ext}",
             "clip_text": ("text_encoder/model.safetensors"
                           if fmt == "safetensors"
                           else "text_encoder/pytorch_model.bin"),
             "controlnet_tile": ("controlnet_tile/controlnet_tile.safetensors"
                                 if fmt == "safetensors" else
                                 "controlnet_tile/diffusion_pytorch_model.bin"),
             "controlnet_depth": f"controlnet_depth/diffusion_pytorch_model."
                                 f"{ext}",
             "controlnet_ip2p": f"controlnet_ip2p/diffusion_pytorch_model."
                                f"{ext}"}
    for name, rel in names.items():
        kind = "controlnet" if name.startswith("controlnet") else name
        _write(os.path.join(root, rel), torch_state_from_flax(trees[name],
                                                              kind), fmt)
    # SRVGG in Real-ESRGAN's layout, under "params_ema" as its .pth files
    net = SRVGGNetCompact(num_feat=8, num_conv=2)
    sp = jitter(net.init(jax.random.PRNGKey(seed + 6),
                         jnp.zeros((1, 16, 16, 3)))["params"], seed + 6)
    trees["srvgg"] = sp
    srvgg = {k: torch.as_tensor(np.array(v)) for k, v in
             srvgg_state_from_flax(sp, num_conv=2).items()}
    path = os.path.join(root, "image_enhancer",
                        "model.safetensors" if fmt == "safetensors"
                        else "pytorch_model.bin")
    if fmt == "safetensors":
        _write(path, srvgg, fmt)
    else:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"params_ema": srvgg}, path)
    # the IP-Adapter's vision tower (transformers keys) and its npz
    vision = CLIPVisionModel(CLIPVisionConfig(**TINY_VISION))
    vp = jitter(vision.init(jax.random.PRNGKey(seed + 7),
                            jnp.zeros((1, 32, 32, 3)))["params"], seed + 7)
    trees["clip_vision"] = vp
    state = torch_state_from_flax(vp, "clip_vision")
    state["vision_model.embeddings.position_ids"] = torch.arange(
        17)[None]                              # a buffer transformers keeps
    _write(os.path.join(root, "ip_adapter_vision",
                        f"model.{ext}" if fmt == "safetensors"
                        else "pytorch_model.bin"), state, fmt)
    proj = ImageProjModel(cross_attention_dim=32, clip_embed_dim=32,
                          num_tokens=4)
    pp = jitter(proj.init(jax.random.PRNGKey(seed + 8),
                          jnp.zeros((1, 32)))["params"], seed + 8)
    full = UNet2DCondition(jr._tiny_unet_cfg()).init(
        jax.random.PRNGKey(seed + 9), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 32)),
        mode=AttnMode(ip_tokens=4),
        ip_context=jnp.zeros((1, 4, 32)))["params"]
    patch = {k: v for k, v in flatten(jitter(full, seed + 9)).items()
             if "/ip_to_" in k}
    trees["image_proj"], trees["unet_ip"] = pp, patch
    os.makedirs(os.path.join(root, "ip_adapter"), exist_ok=True)
    np.savez(os.path.join(root, "ip_adapter", "ip_adapter.npz"),
             **{f"image_proj/{k}": v for k, v in flatten(pp).items()},
             **{f"unet_patch/{k}": v for k, v in patch.items()})
    return trees
