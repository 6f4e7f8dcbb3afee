"""View and ray sharding over a `torch.distributed` process group
(counterpart of `mvedit_tpu/parallel/sharded.py`).

The reference runs one SPMD program over a `jax.sharding.Mesh` and lets
XLA insert the collectives. Here every rank runs the same Python over a
one-dimensional `DeviceMesh` ("dp"): NCCL on the card, gloo on the CPU.
Each rank holds the whole inputs (drawn from one seed), takes its
contiguous slice of the sharded axis, and meets the others where the
reference's collectives are:

- **denoise**: the 2N CFG batch is split over the ranks. Joint
  cross-image attention folds a view group into one sequence: a rank that
  holds part of a group all-gathers the group's K and V before attention
  (`ViewShard`); a rank that holds whole groups gathers nothing. The
  outputs are gathered back where the CFG combine needs both halves.
- **fits**: rays (NeRF) or pixel rows and regulariser face samples (mesh)
  are split; what the loss reads is gathered back (`all_gather_cat`) or
  summed (`reduce_sum`), so that every rank computes the same loss, and
  after the backward every gradient is all-reduced as a sum and divided
  by the world size (`all_reduce_mean_grads_`). Both collectives'
  backwards all-reduce their output gradient, which makes the rule exact
  for replicated and sharded terms alike.

At world size 1 every slice is the whole tensor and every collective the
identity, so a 1-rank run does the unsharded arithmetic, bit for bit.

Launch one process per card with `torchrun` (or spawn them), call
`torch.distributed.init_process_group` with the backend, the address, the
world size and the rank, then `make_mesh()`; set `models.device_mesh` to
shard a `MVEdit3DPipeline`.
"""
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_sharded_denoise_step",
           "make_sharded_nerf_step", "dryrun", "dryrun_pipeline",
           "ViewShard", "ShardedViews", "shard", "all_gather_cat",
           "reduce_sum", "all_reduce_mean_grads_", "replicate_"]


def make_mesh(n_devices=None, axis="dp"):
    """A one-dimensional `DeviceMesh` named `axis` over the initialised
    default process group (n_devices defaults to its world size)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group "
                           "(or run under torchrun) first")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks over a group of "
                         f"{dist.get_world_size()}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, (n,), mesh_dim_names=(axis,))


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _info(mesh):
    """(group, world size, this rank's index) of the mesh's one axis."""
    axis = mesh.mesh_dim_names[0]
    return mesh.get_group(axis), mesh.size(), mesh.get_local_rank(axis)


def shard(x, mesh, dim=0):
    """This rank's contiguous slice of `x` along `dim` (which the world
    size must divide)."""
    _, world, rank = _info(mesh)
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"axis of {n} over {world} ranks")
    return x.narrow(dim, rank * (n // world), n // world)


def _gather(x, group, world):
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        group, world, rank = _info(mesh)
        ctx.mesh, ctx.dim, ctx.rank, ctx.n = mesh, dim, rank, x.shape[dim]
        return torch.cat(_gather(x, group, world), dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_info(ctx.mesh)[0])
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.clone()
        dist.all_reduce(x, group=_info(mesh)[0])
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_info(ctx.mesh)[0])
        return g, None


def all_gather_cat(x, mesh, dim=0):
    """Every rank's slice concatenated along `dim`, in rank order. Its
    backward all-reduces the output gradient and takes this rank's
    slice."""
    return _GatherCat.apply(x, mesh, dim)


def reduce_sum(x, mesh):
    """The sum of `x` over the ranks; its backward all-reduces too."""
    return _ReduceSum.apply(x, mesh)


@torch.no_grad()
def all_reduce_mean_grads_(params, mesh):
    """Each gradient summed over the ranks, then divided by the world
    size, in place."""
    group, world, _ = _info(mesh)
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)
            p.grad.div_(world)


@torch.no_grad()
def replicate_(tree, mesh):
    """Broadcast every tensor of a (nested dict / list / tuple) tree from
    the mesh's first rank, in place."""
    group, _, _ = _info(mesh)
    src = dist.get_global_rank(group, 0)
    _tree_map(lambda t: dist.broadcast(t, src, group=group)
              if torch.is_tensor(t) else None, tree)


@dataclass(frozen=True, eq=False)
class ViewShard:
    """This rank's rows of a batch split over `mesh`: `b` rows from row
    rank * b. Joint self-attention over view groups of N consecutive rows
    calls `group_kv` when the rank holds part of a group (N a multiple of
    b), which returns the group's (1, N * L, C) rows gathered across the
    ranks in order."""
    mesh: object
    b: int

    def holds_whole_groups(self, num_views):
        return self.b % num_views == 0

    def group_kv(self, kv, num_views):
        group, world, rank = _info(self.mesh)
        per = num_views // self.b            # ranks a view group spans
        first = rank // per * per
        parts = _gather(kv, group, world)[first:first + per]
        return torch.cat(parts, 0).reshape(1, -1, kv.shape[-1])


def _first_batch(tree):
    found = []
    _tree_map(lambda x: found.append(x.shape[0])
              if torch.is_tensor(x) and x.dim() else None, tree)
    return found[0] if found else None


class ShardedViews:
    """`fn` with its batch split over `mesh`: a call slices every tensor
    whose leading axis is the call's batch B to this rank's rows, runs
    `fn` on them (a `mode=` keyword gains a `ViewShard`), and all-gathers
    the outputs back to B rows. Where B or its joint view groups do not
    split evenly (B % world, or neither of b and num_views dividing the
    other) the call runs whole on every rank, as the reference leaves an
    uneven batch unsharded. For inference: the gathers carry no
    gradient."""

    def __init__(self, fn, mesh):
        self.fn, self.mesh = fn, mesh

    def __call__(self, *args, **kw):
        _, world, rank = _info(self.mesh)
        B = _first_batch((args, kw))
        mode = kw.get("mode")
        nv = 1 if mode is None else max(mode.num_views, 1)
        if B is None or B % world:
            return self.fn(*args, **kw)
        b = B // world
        if nv > 1 and b % nv and nv % b:
            return self.fn(*args, **kw)

        def take(x):
            if torch.is_tensor(x) and x.dim() and x.shape[0] == B:
                return x.narrow(0, rank * b, b)
            return x
        args, kw = _tree_map(take, args), _tree_map(take, kw)
        if mode is not None:
            kw["mode"] = replace(mode, views=ViewShard(self.mesh, b))
        out = self.fn(*args, **kw)
        group = _info(self.mesh)[0]
        return _tree_map(
            lambda x: torch.cat(_gather(x, group, world), 0)
            if torch.is_tensor(x) and x.dim() and x.shape[0] == b else x,
            out)


def make_sharded_denoise_step(net, mesh, mode, guidance_scale=7.5):
    """`step(lat, t, ctx)` on this rank's slices of the 2N CFG batch
    [uncond; cond] -> this rank's slice of the guided eps [g; g]: the net
    runs on the slice (joint attention gathering the view groups' K and V
    where a group spans ranks), the eps are gathered for the CFG combine."""
    group, world, _ = _info(mesh)

    @torch.inference_mode()
    def step(lat, t, ctx):
        b, nv = lat.shape[0], max(mode.num_views, 1)
        if b and b % nv and nv % b:
            raise ValueError(f"{b} images a rank split view groups of {nv}")
        views = replace(mode, views=ViewShard(mesh, b))
        eps = net(lat, t, ctx, mode=views)
        eps = torch.cat(_gather(eps, group, world), 0)
        eps_u, eps_c = eps.chunk(2, 0)
        g = eps_u + guidance_scale * (eps_c - eps_u)
        return shard(torch.cat([g, g], 0), mesh)

    return step


def make_sharded_nerf_step(point_decode_fn, render_cfg, mesh, lr=1e-2):
    """One NeRF step with rays sharded over the mesh and parameters
    replicated: `step(params, opt, rays_o, rays_d, target_rgb)` on this
    rank's ray slices -> (params, opt, loss), params updated in place. Each
    rank's loss is the mean L1 over its slice; the gradients are summed
    over the ranks and divided by the world size, and every rank takes the
    same Adam step (optax.adam's defaults). The loss returned is the mean
    over the ranks. Returns (step, make_optimizer)."""
    from functools import partial

    from ..models.fields import field_leaves
    from ..models.volume_renderer import render_rays
    group, world, _ = _info(mesh)

    def make_optimizer(params):
        leaves = field_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.Adam(leaves, lr=lr)

    def step(params, opt, rays_o, rays_d, target_rgb):
        opt.zero_grad(set_to_none=True)
        out = render_rays(partial(point_decode_fn, params), rays_o, rays_d,
                          render_cfg, bg_color=1.0)
        loss = (out["rgb"] - target_rgb).abs().mean()
        loss.backward()
        leaves = opt.param_groups[0]["params"]
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_mean_grads_(leaves, mesh)
        opt.step()
        with torch.no_grad():
            mean = loss.detach().clone()
            dist.all_reduce(mean, group=group)
        return params, opt, mean / world

    return step, make_optimizer


def _device(mesh):
    return torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")


def dryrun(n_devices: int) -> None:
    """Build an n-rank mesh over the initialised group and run each sharded
    step once at tiny shapes: one CFG denoise forward (N = n // 2 views,
    so 2N images, one a rank; none at n = 1, as in the reference), one
    NeRF step (8 rays a rank) and one DMTet mesh-fit step (pixel rows and
    regulariser faces sharded)."""
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"dryrun needs a process group of {n_devices} "
                           f"ranks, found {have}")
    import numpy as np

    from ..apis.cameras import surround_rig
    from ..models import mesh_fit as MF
    from ..models.diffusion import AttnMode
    from ..models.fields import ingp_init, ingp_point_decode
    from ..models.mesh.rasterize import RasterConfig
    from ..models.mesh.structured_tets import StructuredTetGrid
    from ..models.volume_renderer import RenderConfig
    from ..testing import TINY_INGP, make_tiny_models
    from ..utils import camera as cam_utils

    mesh = make_mesh(n_devices)
    dev = _device(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = make_tiny_models(gen, n_cn=0)

    N = n_devices // 2
    step = make_sharded_denoise_step(m.unet, mesh, AttnMode(num_views=N))
    lat = torch.randn((2 * N, 8, 8, 4), generator=gen, device=dev)
    t = torch.full((2 * N,), 500, dtype=torch.int32, device=dev)
    ctx = torch.zeros((2 * N, 8, 32), device=dev)
    eps = step(shard(lat, mesh), shard(t, mesh), shard(ctx, mesh))
    if eps.shape != shard(lat, mesh).shape or not torch.isfinite(eps).all():
        raise RuntimeError("sharded denoise step failed")

    fparams = ingp_init(TINY_INGP, gen, dev)

    def point_decode(p, xyz):
        return ingp_point_decode(p, xyz, TINY_INGP)
    nerf_step, make_opt = make_sharded_nerf_step(
        point_decode, RenderConfig(num_samples=8, grid_size=8), mesh)
    R = 8 * n_devices
    rays_o = torch.tensor([[0.0, 0.0, -2.0]], device=dev).expand(R, 3)
    rays_d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(R, 3)
    target = torch.full((R, 3), 0.5, device=dev)
    fparams, _, loss = nerf_step(fparams, make_opt(fparams),
                                 shard(rays_o, mesh), shard(rays_d, mesh),
                                 shard(target, mesh))
    if not torch.isfinite(loss):
        raise RuntimeError("sharded NeRF step failed")

    tgrid = StructuredTetGrid(8)
    hp = n_devices * 4
    mcfg = MF.MeshFitConfig(
        raster=RasterConfig(height=hp, width=hp, k_per_tile=64, k_big=16),
        n_steps=1, render_bs=2, reg_face_samples=n_devices * 16,
        vert_cap=512, face_cap=1024, patch_size=hp, freeze_topology=True)
    mfit, mopt, _ = MF.make_mesh_fit(
        tgrid, lambda p, x: ingp_point_decode(p, x, TINY_INGP)[1], mcfg,
        mesh=mesh)
    gv = np.asarray(tgrid.verts)
    mstate = {"field": fparams,
              "sdf": torch.as_tensor(0.6 - np.linalg.norm(gv, axis=-1),
                                     dtype=torch.float32, device=dev),
              "deform": torch.zeros((len(gv), 3), device=dev)}
    rngm = np.random.default_rng(0)
    poses_m, intr_m = surround_rig(2, 2.5, 40, 0.0, 0.3, hp, rng=rngm)
    lights_m, _ = cam_utils.light_sampling(poses_m, rng=rngm)

    def t_(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)
    mtargets = {"images": torch.full((2, hp, hp, 3), 0.5, device=dev),
                "masks": torch.ones((2, hp, hp, 1), device=dev),
                "poses": t_(poses_m), "intrinsics": t_(intr_m),
                "cam_weights": torch.ones((2,), device=dev),
                "cam_lights": t_(lights_m)}
    gen.manual_seed(1)
    _, _, mout = mfit(mstate, mopt(mstate), mtargets, generator=gen)
    if not torch.isfinite(mout["loss"]).all():
        raise RuntimeError("sharded mesh-fit step failed")


def dryrun_pipeline(mesh, num_views=None, steps=3, seed=0):
    """The whole tiny MVEdit 3D pipeline sharded over `mesh` (None: the
    same request unsharded, on the CPU). num_views defaults to half the
    world size (at least 2), so that the 2N CFG batch puts one image on
    each rank."""
    import numpy as np

    from ..apis.cameras import surround_rig
    from ..pipelines import MVEdit3DPipeline
    from ..testing import make_tiny_models, make_tiny_mvedit_cfg
    from ..utils import camera as cam_utils

    dev = torch.device("cpu") if mesh is None else _device(mesh)
    world = 1 if mesh is None else mesh.size()
    N = num_views if num_views is not None else max(world // 2, 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m = make_tiny_models(gen)
    m.device_mesh = mesh
    size = 32
    cfg = make_tiny_mvedit_cfg(num_views=N, render_size=size, steps=steps,
                               nerf_switch_progress=0.5)
    rng = np.random.default_rng(seed)
    poses, intr = surround_rig(N, 2.5, 40, 0.0, 0.3, size, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)

    def t_(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)
    targets = {"images": torch.full((N, size, size, 3), 0.5, device=dev),
               "masks": torch.ones((N, size, size, 1), device=dev),
               "poses": t_(poses), "intrinsics": t_(intr),
               "cam_weights": torch.ones((N,), device=dev),
               "cam_lights": t_(lights)}
    embeds = torch.zeros((N, 8, 32), device=dev)
    gen.manual_seed(seed + 1)
    return MVEdit3DPipeline(m, cfg)(targets, embeds, embeds, generator=gen)
