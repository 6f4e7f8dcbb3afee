"""Neural fields: the iNGP-style field as a dict of tensors (counterpart of
`mvedit_tpu/models/fields.py`).

Hash-grid (`backend="hash"`, the reference's default) or dense-grid
encoding -> ReLU MLP -> (sigma via trunc_exp + a density blob at the
origin, rgb via a saturated sigmoid). Parameters are a plain nested dict,
`{"table": ..., "mlp": [{"w", "b"}, ...]}`, the JAX pytree's layout: the
table is one (L, T, F) tensor for the hash grid and `{"level_i": ...}` for
the dense grid. `field_params_from_flax` bridges them leaf for leaf and
the fits hand `field_leaves` to their optimizer.
"""
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.activation import trunc_exp
from ..ops.clip import clip
from ..ops.dense_grid import (DenseGridConfig, dense_grid_encode,
                              dense_grid_init)
from ..ops.hash_grid import HashGridConfig, hash_grid_encode, hash_grid_init

__all__ = ["mlp_init", "mlp_apply", "INGPConfig", "ingp_init",
           "ingp_point_decode", "ingp_density", "FieldColor",
           "FieldShading", "field_params_from_flax", "field_leaves"]


def mlp_init(dims, generator=None, device=None):
    """Xavier-uniform MLP params for layer sizes `dims`, zero biases; drawn
    on the generator's device and moved to `device`."""
    params = []
    draw = generator.device if generator is not None else device
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = (6.0 / (d_in + d_out)) ** 0.5
        w = torch.rand((d_in, d_out), generator=generator, device=draw)
        params.append({"w": (w * (2 * bound) - bound).to(device),
                       "b": torch.zeros((d_out,), device=device)})
    return params


def mlp_apply(params, x):
    """ReLU MLP in f32; no activation on the last layer."""
    x = x.float()
    for i, layer in enumerate(params):
        x = x @ layer["w"].float() + layer["b"]
        if i != len(params) - 1:
            x = torch.relu(x)
    return x


@dataclass(frozen=True)
class INGPConfig:
    hash: HashGridConfig = field(default_factory=HashGridConfig)
    dense: DenseGridConfig = field(default_factory=DenseGridConfig)
    backend: str = "hash"          # or "dense"
    num_layers: int = 2
    hidden_dim: int = 64
    sigmoid_saturation: float = 0.001
    blob_density: float = 1.0
    blob_radius: float = 0.2
    bound: float = 1.0

    @property
    def enc_dim(self):
        return (self.hash.out_dim if self.backend == "hash"
                else self.dense.out_dim)

    @property
    def mlp_dims(self):
        return (self.enc_dim,
                *([self.hidden_dim] * (self.num_layers - 1)), 4)


def ingp_init(cfg: INGPConfig, generator=None, device=None):
    table = (dense_grid_init(cfg.dense, generator, device)
             if cfg.backend == "dense"
             else hash_grid_init(cfg.hash, generator, device))
    return {"table": table, "mlp": mlp_init(cfg.mlp_dims, generator, device)}


def _density_blob(xyz, cfg: INGPConfig):
    """Gaussian density prior at the origin."""
    d = clip((xyz * xyz).sum(-1), 0.2)
    return cfg.blob_density * torch.exp(-d / (2.0 * cfg.blob_radius ** 2))


def ingp_point_decode(params, xyz, cfg: INGPConfig):
    """xyz: (..., 3) world points in [-bound, bound] -> (sigma (...,),
    rgb (..., 3))."""
    x01 = (xyz + cfg.bound) / (2.0 * cfg.bound)
    if cfg.backend == "dense":
        enc = dense_grid_encode(params["table"], x01, cfg.dense)
    else:
        enc = hash_grid_encode(params["table"], x01, cfg.hash)
    h = mlp_apply(params["mlp"], enc)
    sigma = trunc_exp(h[..., 0] + _density_blob(xyz, cfg))
    rgb = torch.sigmoid(h[..., 1:])
    if cfg.sigmoid_saturation > 0:
        rgb = rgb * (1 + 2 * cfg.sigmoid_saturation) - cfg.sigmoid_saturation
    return sigma, rgb


def ingp_density(params, xyz, cfg: INGPConfig):
    return ingp_point_decode(params, xyz, cfg)[0]


class FieldColor:
    """Albedo callback `fn(params, xyz) -> rgb` of a field config."""

    def __init__(self, cfg: INGPConfig):
        self.cfg = cfg

    def __call__(self, params, xyz):
        return ingp_point_decode(params, xyz, self.cfg)[1]


class FieldShading(FieldColor):
    """`render_views` shading form of FieldColor: ignores the normal and
    the view direction (the albedo field is composited by the caller)."""

    def __call__(self, params, xyz, normal, view_dir):
        return ingp_point_decode(params, xyz, self.cfg)[1]


def field_params_from_flax(tree, device=None):
    """The JAX field pytree (`ingp_init`'s `{"table": (L, T, F) or
    {"level_i"}, "mlp": [{"w", "b"}]}`, leaves as numpy or JAX arrays) ->
    the port's params, float32 tensors on `device`."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    table = tree["table"]
    return {"table": ({k: t(v) for k, v in table.items()}
                      if isinstance(table, dict) else t(table)),
            "mlp": [{"w": t(l["w"]), "b": t(l["b"])} for l in tree["mlp"]]}


def field_leaves(params):
    """The field's tensors in a fixed order (the hash table, or the dense
    tables by level, then the MLP's)."""
    table = params["table"]
    tables = ([table[k] for k in sorted(table)] if isinstance(table, dict)
              else [table])
    return tables + [l[n] for l in params["mlp"] for n in ("w", "b")]
