"""Inception feature statistics of a dataset (counterpart of
`tools/inception_stat.py`): the dataset's views, resized to 299^2
(`ops/image.py::resize_bilinear`, the antialiased `jax.image.resize`),
through `InceptionV3Features` in batches; {feats, mu, sigma} are saved
to an `.npz` for FID / KID (`utils/evaluation.py`).

  python -m mvedit_tpu_torch.tools.inception_stat --data DIR \\
      --out work_dirs/cache/cars_test_inception.npz [--num-scenes N]

`--checkpoint-dir D` reads `D/inception/` (a `.safetensors` or torch
state dict with torchvision's keys, under the file names the runner
searches); without it the weights are seeded (seed 0) and the features
only self-consistent. Runs on the card unless `--device cpu`.
"""
import argparse
import os

import numpy as np
import torch

__all__ = ["main", "load_inception"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-scenes", type=int, default=None)
    ap.add_argument("--views-per-scene", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="dir whose inception/ holds the converted "
                         "weights; seeded weights otherwise")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_inception(checkpoint_dir, device):
    """`InceptionV3Features` on `device`: from `checkpoint_dir/inception/`,
    or seeded from a CPU generator of seed 0, the same on every device
    (flax's default init: conv weights N(0, 1 / fan_in), BN scale 1, bias
    0, running mean 0 and var 1)."""
    from ..apis.runner import _CHECKPOINT_FILES, init_random_
    from ..models.diffusion.weights import load_torch_state
    from ..models.inception import InceptionV3Features
    with torch.device(device):
        net = InceptionV3Features()
    if checkpoint_dir:
        d = os.path.join(checkpoint_dir, "inception")
        path = next((os.path.join(d, f) for f in _CHECKPOINT_FILES
                     if os.path.exists(os.path.join(d, f))), None)
        if path is None:
            raise FileNotFoundError(f"no inception weights under {d}")
        missing, unexpected = net.load_state_dict(load_torch_state(path),
                                                  strict=False)
        missing = [k for k in missing if "num_batches_tracked" not in k]
        if missing or unexpected:
            raise KeyError(f"{path}: missing {missing[:5]}, unexpected "
                           f"{unexpected[:5]}")
    else:
        with torch.no_grad():
            init_random_(net, torch.Generator().manual_seed(0))
        print("WARNING: seeded inception weights; features are only "
              "self-consistent")
    return net.eval()


def main(argv=None):
    """Writes the `.npz`; returns {feats, mu, sigma}."""
    args = parse_args(argv)
    from ..datasets import ShapeNetSRN
    from ..ops.image import resize_bilinear

    device = torch.device(args.device)
    net = load_inception(args.checkpoint_dir, device)
    dataset = ShapeNetSRN(args.data)
    n = min(args.num_scenes or len(dataset), len(dataset))
    imgs = []
    for i in range(n):
        v = dataset[i]["images"]
        if args.views_per_scene:
            v = v[:args.views_per_scene]
        imgs.append(v)
    imgs = np.concatenate(imgs, axis=0)
    print(f"{imgs.shape[0]} images from {n} scenes")

    feats = []
    with torch.no_grad():
        for i in range(0, len(imgs), args.batch):
            batch = torch.as_tensor(imgs[i:i + args.batch], device=device,
                                    dtype=torch.float32)
            batch = resize_bilinear(batch, (299, 299))
            feats.append(net(batch.permute(0, 3, 1, 2)).cpu().numpy())
    feats = np.concatenate(feats, axis=0)
    mu = feats.mean(0)
    sigma = np.cov(feats, rowvar=False)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, feats=feats, mu=mu, sigma=sigma)
    print(f"saved {feats.shape} features -> {args.out}")
    return {"feats": feats, "mu": mu, "sigma": sigma}


if __name__ == "__main__":
    main()
