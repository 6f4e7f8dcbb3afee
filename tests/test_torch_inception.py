"""`mvedit_tpu_torch/models/inception.py` and `tools/inception_stat.py`
against the JAX package's, on the CPU in f32, with the flax params bridged
(`inception_state_from_flax`, `aesthetic_state_from_flax`):

- `InceptionV3Features` at 75^2 (the smallest input its strides take),
  with the BatchNorm statistics and scales jittered so that every one
  counts: the (B, 2048) features within 1e-5 relative (L2);
- `AestheticHead` on seeded embeddings: the scores within 1e-6 relative;
- `inception_stat` on a tiny SRN-layout dataset (2 scenes x 2 views of
  16^2, resized to 299^2): the JAX tool with its seeded weights
  (PRNGKey(0)) and the port's tool with those weights bridged and read
  from `--checkpoint-dir` write `.npz` files whose `feats` and `mu` agree
  within 1e-5 and `sigma` within 1e-4 relative (L2; a covariance of 4
  samples, its entries products of the features' deviations).
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvedit_tpu.models import inception as JI
from mvedit_tpu_torch.models import inception as TI

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jitter_bn(params, seed):
    rng = np.random.default_rng(seed)

    def f(path, p):
        p = np.asarray(p)
        name = path[-1].key
        if name == "var":
            return p * rng.uniform(0.5, 2.0, p.shape).astype(np.float32)
        if name in ("mean", "bias", "scale"):
            return p + 0.1 * rng.standard_normal(p.shape).astype(np.float32)
        return p
    return jax.tree_util.tree_map_with_path(f, params)


def test_inception_features_match_jax():
    net = JI.InceptionV3Features()
    params = _jitter_bn(net.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 75, 75, 3)))["params"], 1)
    x = np.random.default_rng(2).random((2, 75, 75, 3)).astype(np.float32)
    jf = net.apply({"params": params}, jnp.asarray(x))
    tnet = TI.InceptionV3Features()
    missing, unexpected = tnet.load_state_dict(
        TI.inception_state_from_flax(params), strict=False)
    assert not unexpected
    assert all("num_batches_tracked" in k for k in missing)
    with torch.no_grad():
        tf = tnet(_t(x).permute(0, 3, 1, 2))
    assert tf.shape == (2, 2048)
    assert _rel(tf, jf) <= 1e-5


def test_aesthetic_head_matches_jax():
    head = JI.AestheticHead()
    emb = np.random.default_rng(3).normal(size=(4, 768)).astype(np.float32)
    params = head.init(jax.random.PRNGKey(4), jnp.zeros((1, 768)))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    js = head.apply({"params": params}, jnp.asarray(emb))
    thead = TI.AestheticHead()
    thead.load_state_dict(TI.aesthetic_state_from_flax(params), strict=True)
    with torch.no_grad():
        ts = thead(_t(emb))
    assert ts.shape == (4,)
    assert _rel(ts, js) <= 1e-6


def _srn(root, scenes=2, views=2, size=16):
    from PIL import Image
    for s in range(scenes):
        d = os.path.join(root, f"scene{s}")
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "pose"))
        rng = np.random.default_rng(10 + s)
        for i in range(views):
            Image.fromarray((rng.random((size, size, 3)) * 255).astype(
                np.uint8)).save(os.path.join(d, "rgb", f"{i:06d}.png"))
            np.savetxt(os.path.join(d, "pose", f"{i:06d}.txt"),
                       np.eye(4).reshape(1, 16))
        with open(os.path.join(d, "intrinsics.txt"), "w") as f:
            f.write(f"{size} {size / 2} {size / 2} 0\n0 0 0\n{size} "
                    f"{size}\n")


def test_inception_stat_matches_the_jax_tool(tmp_path, monkeypatch):
    data = str(tmp_path / "srn")
    _srn(data)
    spec = importlib.util.spec_from_file_location(
        "jax_inception_stat",
        os.path.join(REPO, "tools", "inception_stat.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    jout = str(tmp_path / "jax.npz")
    monkeypatch.setattr(sys, "argv", ["inception_stat", "--data", data,
                                      "--out", jout, "--batch", "3"])
    jtool.main()
    # the JAX tool's seeded weights, bridged into the port's checkpoint dir
    params = JI.InceptionV3Features().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3)))["params"]
    os.makedirs(tmp_path / "ckpt" / "inception")
    torch.save(TI.inception_state_from_flax(params),
               str(tmp_path / "ckpt" / "inception" / "pytorch_model.bin"))
    from mvedit_tpu_torch.tools import inception_stat
    tout = str(tmp_path / "port.npz")
    got = inception_stat.main(["--data", data, "--out", tout, "--batch",
                               "3", "--checkpoint-dir",
                               str(tmp_path / "ckpt"), "--device", "cpu"])
    j, t = np.load(jout), np.load(tout)
    assert t["feats"].shape == j["feats"].shape == (4, 2048)
    np.testing.assert_array_equal(got["feats"], t["feats"])
    assert _rel(t["feats"], j["feats"]) <= 1e-5
    assert _rel(t["mu"], j["mu"]) <= 1e-5
    assert _rel(t["sigma"], j["sigma"]) <= 1e-4
    with pytest.raises(FileNotFoundError):
        inception_stat.main(["--data", data, "--out", tout,
                             "--checkpoint-dir", str(tmp_path),
                             "--device", "cpu"])
