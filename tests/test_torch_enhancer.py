"""The port's SRVGG image enhancer.

- Against the JAX module on bridged weights (`srvgg_state_from_flax`), at
  a small width (8 features, 2 convs) and at the published one (64, 32)
  on a 12^2 input: within 1e-5 relative to the output's magnitude (f32
  convolutions in another order).
- The port keeps Real-ESRGAN's own layout: a state dict with its keys
  (`body.0` ... `body.{2n+2}`, no `conv_up`) loads strictly, and the last
  conv's channels are read as PixelShuffle's (3, r, r): pinned against the
  net written out with `F.conv2d`, `F.prelu` and `F.pixel_shuffle`. (The
  JAX package's `convert_srvgg` names that conv `body_{2n+2}` and reads
  its channels as (r, r, 3): ROADMAP Queue 3.)
- The runner's `enhance_fn`: 4x, then resized to the diffusion size
  (antialiased when it shrinks), clipped to [0, 1].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvedit_tpu.models.image_enhancer import SRVGGNetCompact as JSR

from mvedit_tpu_torch.apis import Adapter3DRunner
from mvedit_tpu_torch.models.image_enhancer import (SRVGGNetCompact,
                                                    srvgg_state_from_flax)

torch.set_num_threads(2)


@pytest.mark.parametrize("feat,conv", [(8, 2), (64, 32)])
def test_srvgg_matches_jax(feat, conv):
    net = JSR(num_feat=feat, num_conv=conv)
    x = np.random.default_rng(0).random((2, 12, 12, 3)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 12, 12, 3)))[
        "params"]
    # PReLU slopes and biases off their constant inits
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), params)
    ref = np.asarray(net.apply({"params": params}, x))
    port = SRVGGNetCompact(num_feat=feat, num_conv=conv)
    port.load_state_dict(srvgg_state_from_flax(params, conv))
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_srvgg_loads_real_esrgan_layout():
    n, feat, r = 2, 8, 4
    g = torch.Generator().manual_seed(0)
    sd = {}
    for i in range(n + 1):
        cin = 3 if i == 0 else feat
        sd[f"body.{2 * i}.weight"] = torch.randn((feat, cin, 3, 3),
                                                 generator=g) * 0.2
        sd[f"body.{2 * i}.bias"] = torch.randn((feat,), generator=g) * 0.1
        sd[f"body.{2 * i + 1}.weight"] = torch.rand((feat,), generator=g)
    sd[f"body.{2 * n + 2}.weight"] = torch.randn((3 * r * r, feat, 3, 3),
                                                 generator=g) * 0.2
    sd[f"body.{2 * n + 2}.bias"] = torch.randn((3 * r * r,), generator=g)
    net = SRVGGNetCompact(num_feat=feat, num_conv=n)
    net.load_state_dict(sd, strict=True)
    x = torch.rand((1, 5, 7, 3), generator=g)
    h = x.permute(0, 3, 1, 2)
    base = F.interpolate(h, scale_factor=r, mode="nearest")
    for i in range(n + 1):
        h = F.prelu(F.conv2d(h, sd[f"body.{2 * i}.weight"],
                             sd[f"body.{2 * i}.bias"], padding=1),
                    sd[f"body.{2 * i + 1}.weight"])
    h = F.conv2d(h, sd[f"body.{2 * n + 2}.weight"],
                 sd[f"body.{2 * n + 2}.bias"], padding=1)
    ref = (F.pixel_shuffle(h, r) + base).permute(0, 2, 3, 1)
    with torch.no_grad():
        torch.testing.assert_close(net(x), ref, rtol=1e-5, atol=1e-5)
    # a nearest 4x of the input is the base: pixel (4i + a, 4j + b) -> (i, j)
    np.testing.assert_array_equal(base[0, :, ::4, ::4].numpy(),
                                  x[0].permute(2, 0, 1).numpy())


def test_enhance_fn_sizes():
    runner = Adapter3DRunner(tiny_models=True, device="cpu")
    fn = runner.load_image_enhancer()
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    for size in (64, 48, 96):
        out = fn(x, size)
        assert out.shape == (2, size, size, 3)
        assert float(out.min()) >= 0 and float(out.max()) <= 1
    assert fn is runner.load_image_enhancer()
