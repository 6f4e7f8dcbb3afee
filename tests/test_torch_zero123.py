"""Legacy Zero123 (`pipelines/zero123.py`) in the port against the JAX
package's, on the CPU in f32 at tiny widths: an 8-channel tiny UNet, the
tiny VAE, a CLIP vision tower with a 32 projection and
`CLIPCameraProjection`, 2 DDIM steps over "leading" timesteps at 32^2,
with eta 0 and 0.5 (the DDIM noise from JAX's keys through
`torch_jax_draws.JaxZero123Draws`): the novel view within 1e-4, as the
Zero123++ pipeline. `camera_embedding` within 1e-6.

Weights are the JAX models' seeded init plus seeded noise, sent through
the weight bridge (`torch_state_from_flax`).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.diffusion import CLIPVisionConfig as JVisionConfig
from mvedit_tpu.models.diffusion import CLIPVisionModel as JVision
from mvedit_tpu.pipelines import zero123 as JZ

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion import UNet2DCondition
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.clip import (CLIPVisionConfig,
                                                    CLIPVisionModel)
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.pipelines import zero123 as TZ

from torch_jax_draws import JaxZero123Draws

torch.set_num_threads(4)

_VISION = dict(image_size=32, patch_size=8, hidden_size=32,
               intermediate_size=64, num_layers=2, num_heads=4,
               projection_dim=32)


def _jitter(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(
            p.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def models():
    jm = JRunner(tiny_models=True, seed=0).load_stable_diffusion()
    jm.unet_params = _jitter(jm.unet.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 8)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 32)))["params"], 1)
    jm.vae_params = _jitter(jm.vae_params, 2)
    jm.vision = JVision(JVisionConfig(**_VISION))
    jm.vision_params = _jitter(jm.vision.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))["params"], 3)
    jm.ccp = JZ.CLIPCameraProjection(embedding_dim=32)
    jm.ccp_params = _jitter(jm.ccp.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 1, 36)))["params"], 4)

    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    tm = types.SimpleNamespace(schedule=TS.sd_schedule())
    tm.unet = UNet2DCondition(dataclasses.replace(tr._tiny_unet_cfg(),
                                                  in_channels=8)).eval()
    tm.vae = tr.load_stable_diffusion().vae
    tm.vision = CLIPVisionModel(CLIPVisionConfig(**_VISION)).eval()
    tm.ccp = TZ.CLIPCameraProjection(embedding_dim=32).eval()
    for mod, p, kind in ((tm.unet, jm.unet_params, "unet"),
                         (tm.vae, jm.vae_params, "vae"),
                         (tm.vision, jm.vision_params, "clip_vision"),
                         (tm.ccp, jm.ccp_params, "image_proj")):
        mod.load_state_dict(torch_state_from_flax(p, kind))
    return jm, tm


def test_camera_embedding_matches_jax():
    el, az, d = [30.0, -20.0], [45.0, 300.0], [1.2, 3.0]
    ref = np.asarray(JZ.camera_embedding(el, az, d))
    out = TZ.camera_embedding(el, az, d).numpy()
    assert out.shape == ref.shape == (2, 1, 4)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_pipeline_matches_jax(models, eta):
    jm, tm = models
    rng = np.random.default_rng(0)
    img = rng.random((1, 32, 32, 3)).astype(np.float32)
    clip_px = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    cfg = dict(num_steps=2, height=32, width=32, eta=eta)
    ref = np.asarray(JZ.Zero123Pipeline(jm, JZ.Zero123Config(**cfg))(
        jnp.asarray(img), jnp.asarray(clip_px), 30.0, 45.0, 1.2, key))
    out = TZ.Zero123Pipeline(tm, TZ.Zero123Config(**cfg))(
        torch.from_numpy(img), torch.from_numpy(clip_px), 30.0, 45.0, 1.2,
        draws=JaxZero123Draws(key))
    assert out.shape == ref.shape == (1, 32, 32, 3)
    assert ref.std() > 0.01
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
