"""The weight bridge `torch_state_from_flax` against the JAX package's
checkpoint converters, on the runner's tiny configurations.

Round trip: a seeded flax parameter tree goes through the bridge, then back
through `convert_unet` / `convert_controlnet` / `convert_vae` /
`convert_clip_text`, and must come back identical (a pure relabelling and
transposition: no tolerance). The bridged state must also load into the
port's modules with `strict=True`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models.diffusion import (AutoencoderKL, CLIPTextConfig,
                                         CLIPTextModel, ControlNet,
                                         UNet2DCondition, UNetConfig,
                                         VAEConfig)
from mvedit_tpu.models.diffusion import weights as W
import mvedit_tpu_torch.models.diffusion as TD
from mvedit_tpu_torch.models.diffusion.weights import (flatten,
                                                       torch_state_from_flax)

torch.set_num_threads(2)

TINY_UNET = UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=jnp.float32)
TINY_VAE = VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                     dtype=jnp.float32)
TINY_TEXT = CLIPTextConfig(vocab_size=49408, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4)
T_UNET = TD.UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       attn_down=(True, False), cross_attention_dim=32,
                       num_heads=4, dtype=torch.float32)


def _flax_tree(kind):
    key = jax.random.PRNGKey(0)
    lat = jnp.zeros((1, 8, 8, 4))
    t0 = jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 8, 32))
    if kind == "unet":
        return UNet2DCondition(TINY_UNET).init(key, lat, t0, ctx)["params"]
    if kind == "controlnet":
        return ControlNet(TINY_UNET, hint_strides=1).init(
            key, lat, t0, ctx, jnp.zeros((1, 16, 16, 3)))["params"]
    if kind == "vae":
        return AutoencoderKL(TINY_VAE).init(
            key, jnp.zeros((1, 16, 16, 3)))["params"]
    return CLIPTextModel(TINY_TEXT).init(
        key, jnp.zeros((1, 8), jnp.int32))["params"]


def _port_module(kind):
    if kind == "unet":
        return TD.UNet2DCondition(T_UNET)
    if kind == "controlnet":
        return TD.ControlNet(T_UNET, hint_strides=1)
    if kind == "vae":
        return TD.AutoencoderKL(TD.VAEConfig(block_out_channels=(32, 64),
                                             layers_per_block=1,
                                             dtype=torch.float32))
    return TD.CLIPTextModel(TD.CLIPTextConfig(
        vocab_size=49408, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4))


_CONVERT = {"unet": W.convert_unet, "controlnet": W.convert_controlnet,
            "vae": W.convert_vae, "clip_text": W.convert_clip_text}


@pytest.mark.parametrize("kind", ["unet", "controlnet", "vae", "clip_text"])
def test_bridge_round_trip(kind):
    tree = jax.tree_util.tree_map(np.asarray, _flax_tree(kind))
    state = torch_state_from_flax(tree, kind)
    back, unmatched = _CONVERT[kind](
        {k: v.numpy() for k, v in state.items()}, strict=True)
    assert unmatched == []
    a, b = flatten(tree), flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["unet", "controlnet", "vae", "clip_text"])
def test_bridge_loads_strict(kind):
    tree = jax.tree_util.tree_map(np.asarray, _flax_tree(kind))
    module = _port_module(kind)
    module.load_state_dict(torch_state_from_flax(tree, kind), strict=True)


def test_bridge_rejects_unknown_path():
    with pytest.raises(KeyError):
        torch_state_from_flax({"nonsense_7": {"kernel": np.zeros((2, 2))}},
                              "unet")
