"""Rank processes for `test_torch_parallel.py`: `run_ranks` spawns `world`
CPU processes joined over gloo (127.0.0.1, a free port), runs one of the
case functions below in each and returns what each rank returned. The
cases import only torch and the port, so a rank starts in seconds; what
they compare against (the unsharded port, the JAX package) is computed in
the same rank process or handed in as numpy arrays."""
import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, *args, timeout=240):
    """[fn(rank, world, *args) for each rank], each in its own process."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_entry,
                             args=(r, world, port, fn, args, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        assert not alive, f"a rank ran past {timeout} s"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        # written by the rank processes above
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world)]


def _mesh():
    from mvedit_tpu_torch.parallel import make_mesh
    return make_mesh()


# ---------------------------------------------------------------- denoise

def _tiny_unet(state):
    from mvedit_tpu_torch.models.diffusion.unet import UNet2DCondition
    from mvedit_tpu_torch.testing import TINY_UNET
    unet = UNet2DCondition(TINY_UNET)
    unet.load_state_dict(state)
    return unet.eval().requires_grad_(False)


def denoise_case(rank, world, state, lat, t, ctx, num_views, gs):
    """The sharded CFG step on this rank's slices; with `num_views` views
    of one group, also a `ShardedViews` UNet call on the group (whose
    ranks each hold part of it) and the unsharded calls."""
    from mvedit_tpu_torch.models.diffusion import AttnMode
    from mvedit_tpu_torch.parallel import (ShardedViews, make_sharded_denoise_step,
                                           shard)
    mesh = _mesh()
    unet = _tiny_unet(state)
    lat, t, ctx = (torch.from_numpy(x) for x in (lat, t, ctx))
    mode = AttnMode(num_views=num_views)
    step = make_sharded_denoise_step(unet, mesh, mode, gs)
    out = {"step": step(shard(lat, mesh), shard(t, mesh), shard(ctx, mesh))}
    with torch.inference_mode():
        eps = unet(lat, t, ctx, mode=mode)
        u, c = eps.chunk(2, 0)
        g = u + gs * (c - u)
        out["full"] = torch.cat([g, g], 0)
        n = num_views
        out["group"] = ShardedViews(unet, mesh)(lat[:n], t[:n], ctx[:n],
                                                mode=mode)
        out["group_full"] = unet(lat[:n], t[:n], ctx[:n], mode=mode)
    return out


# ---------------------------------------------------------------- fits

def _tiny_field(seed, device="cpu"):
    from mvedit_tpu_torch.models.fields import ingp_init
    from mvedit_tpu_torch.testing import TINY_INGP
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return ingp_init(TINY_INGP, gen, device)


def _leaves(field):
    from mvedit_tpu_torch.models.fields import field_leaves
    return [v.detach() for v in field_leaves(field)]


def _decode(p, xyz):
    from mvedit_tpu_torch.models.fields import ingp_point_decode
    from mvedit_tpu_torch.testing import TINY_INGP
    return ingp_point_decode(p, xyz, TINY_INGP)


def nerf_step_case(rank, world, rays_o, rays_d, target):
    """One sharded NeRF step on this rank's rays, and the unsharded step
    (every ray, no collective) from the same field."""
    from mvedit_tpu_torch.models.volume_renderer import RenderConfig
    from mvedit_tpu_torch.parallel import make_sharded_nerf_step, shard
    mesh = _mesh()
    rcfg = RenderConfig(num_samples=8, grid_size=8)
    step, make_opt = make_sharded_nerf_step(_decode, rcfg, mesh)
    rays_o, rays_d, target = (torch.from_numpy(x) for x in
                              (rays_o, rays_d, target))
    p = _tiny_field(0)
    p, _, loss = step(p, make_opt(p), shard(rays_o, mesh),
                      shard(rays_d, mesh), shard(target, mesh))
    out = {"loss": loss, "params": _leaves(p)}
    if rank == 0:
        from functools import partial

        from mvedit_tpu_torch.models.volume_renderer import render_rays
        q = _tiny_field(0)
        opt = make_opt(q)
        r = render_rays(partial(_decode, q), rays_o, rays_d, rcfg,
                        bg_color=1.0)
        ref_loss = (r["rgb"] - target).abs().mean()
        ref_loss.backward()
        opt.step()
        out["ref_loss"] = ref_loss.detach()
        out["ref_params"] = _leaves(q)
    return out


def _rig(n, size, seed=0):
    from mvedit_tpu_torch.apis.cameras import surround_rig
    from mvedit_tpu_torch.utils import camera as cam_utils
    rng = np.random.default_rng(seed)
    poses, intr = surround_rig(n, 2.5, 40, 0.0, 0.3, size, rng=rng)
    lights, _ = cam_utils.light_sampling(poses, rng=rng)
    return (torch.as_tensor(np.asarray(x), dtype=torch.float32)
            for x in (poses, intr, lights))


def mesh_fit_case(rank, world, sharded):
    """Two DMTet mesh-fit steps (the reference test's configuration) with
    the same draws, sharded over the mesh when `sharded`."""
    from mvedit_tpu_torch.models import mesh_fit as MF
    from mvedit_tpu_torch.models.fields import (INGPConfig, ingp_init,
                                                ingp_point_decode)
    from mvedit_tpu_torch.models.mesh.rasterize import RasterConfig
    from mvedit_tpu_torch.models.mesh.structured_tets import StructuredTetGrid
    from mvedit_tpu_torch.ops.hash_grid import HashGridConfig
    mesh = _mesh() if sharded else None
    grid = StructuredTetGrid(12)
    icfg = INGPConfig(hash=HashGridConfig(n_levels=2, base_resolution=4,
                                          max_resolution=8,
                                          log2_hashmap_size=8),
                      hidden_dim=8)
    cfg = MF.MeshFitConfig(
        raster=RasterConfig(height=64, width=64, k_per_tile=64, k_big=32),
        n_steps=2, render_bs=2, reg_face_samples=256,
        vert_cap=1024, face_cap=2048, patch_size=32, freeze_topology=True)
    fit, make_opt, _ = MF.make_mesh_fit(
        grid, lambda p, x: ingp_point_decode(p, x, icfg)[1], cfg, mesh=mesh)
    poses, intr, lights = _rig(4, 64)
    targets = {"images": torch.full((4, 64, 64, 3), 0.5),
               "masks": torch.ones((4, 64, 64, 1)),
               "normals": torch.full((4, 64, 64, 3), 0.5),
               "normal_weights": torch.ones((4,)),
               "poses": poses, "intrinsics": intr,
               "cam_weights": torch.ones((4,)), "cam_lights": lights}
    gen = torch.Generator()
    gen.manual_seed(0)
    v = np.asarray(grid.verts)
    state = {"field": ingp_init(icfg, gen),
             "sdf": torch.as_tensor(0.6 - np.linalg.norm(v, axis=-1),
                                    dtype=torch.float32),
             "deform": torch.zeros((len(v), 3))}
    gen.manual_seed(1)
    state, _, out = fit(state, make_opt(state), targets, generator=gen)
    return {"loss": out["loss"].detach(), "sdf": state["sdf"].detach(),
            "deform": state["deform"].detach(),
            "field": _leaves(state["field"])}


def nerf_fit_case(rank, world, sharded, patch_size=8, patch_bs=2):
    """One 4-step NeRF-fit chunk of the tiny field on a seeded rig, sharded
    over the mesh when `sharded`; the draws from one seeded generator."""
    from mvedit_tpu_torch.models import nerf_fit as NF
    from mvedit_tpu_torch.models.volume_renderer import (OccupancyGrid,
                                                         RenderConfig)
    mesh = _mesh() if sharded else None
    size = 32
    cfg = NF.NerfFitConfig(render=RenderConfig(num_samples=8, grid_size=8),
                           patch_size=patch_size, patch_bs=patch_bs,
                           n_steps=4)
    fit, make_opt = NF.make_nerf_fit(_decode, cfg, size, mesh=mesh)
    poses, intr, lights = _rig(3, size, seed=2)
    rng = np.random.default_rng(3)
    targets = {"images": torch.as_tensor(rng.uniform(0, 1, (3, size, size,
                                                            3)),
                                         dtype=torch.float32),
               "masks": torch.ones((3, size, size, 1)),
               "poses": poses, "intrinsics": intr,
               "cam_weights": torch.ones((3,)), "cam_lights": lights}
    p = _tiny_field(4)
    gen = torch.Generator()
    gen.manual_seed(5)
    p, _, _, out = fit(p, make_opt(p), OccupancyGrid.create(8), targets,
                       generator=gen)
    return {"loss": out["loss"].detach(),
            "params": _leaves(p)}


def fit_pair_case(rank, world, kind):
    """The sharded fit of `kind` ("nerf" / "mesh") on every rank; on rank
    0 also the unsharded one."""
    from functools import partial
    case = {"nerf": nerf_fit_case, "mesh": mesh_fit_case,
            # 7 x 7 rays split unevenly: they run whole on each rank
            "nerf_uneven": partial(nerf_fit_case, patch_size=7,
                                   patch_bs=1)}[kind]
    runs = [case(rank, world, True)]
    if rank == 0:
        runs.append(case(rank, world, False))
    return runs


def one_rank_case(rank, world):
    """At world size 1: the sharded denoise step, NeRF-fit chunk, mesh fit
    and tiny pipeline against the unsharded ones in this process."""
    from mvedit_tpu_torch.models.diffusion import AttnMode
    from mvedit_tpu_torch.parallel import (dryrun_pipeline,
                                           make_sharded_denoise_step)
    from mvedit_tpu_torch.testing import make_tiny_models
    mesh = _mesh()
    gen = torch.Generator()
    gen.manual_seed(7)
    m = make_tiny_models(gen, n_cn=0)
    lat = torch.randn((4, 8, 8, 4), generator=gen)
    t = torch.full((4,), 500, dtype=torch.int32)
    ctx = torch.randn((4, 8, 32), generator=gen)
    mode = AttnMode(num_views=2)
    step = make_sharded_denoise_step(m.unet, mesh, mode, 5.0)
    sharded = step(lat, t, ctx)
    try:   # 6 images do not hold whole groups of 4 views
        make_sharded_denoise_step(m.unet, mesh, AttnMode(num_views=4))(
            lat.repeat(2, 1, 1, 1)[:6], t.repeat(2)[:6],
            ctx.repeat(2, 1, 1)[:6])
        refused = False
    except ValueError:
        refused = True
    with torch.inference_mode():
        u, c = m.unet(lat, t, ctx, mode=mode).chunk(2, 0)
        g = u + 5.0 * (c - u)
    pipe = [dryrun_pipeline(m_, 2, 2, 3) for m_ in (mesh, None)]
    return {"refused": refused,
            "denoise": (sharded, torch.cat([g, g], 0)),
            "pipeline": tuple((p["renders"]["rgb"],
                               p["mesh_state"]["sdf"].detach(),
                               p["mesh"].v, p["mesh"].albedo) for p in pipe),
            "nerf": (nerf_fit_case(rank, world, True),
                     nerf_fit_case(rank, world, False)),
            "mesh": (mesh_fit_case(rank, world, True),
                     mesh_fit_case(rank, world, False))}


def dryrun_case(rank, world):
    from mvedit_tpu_torch.parallel import dryrun
    dryrun(world)
    return True


def two_rank_cases(rank, world, denoise_args, nerf_args, pipeline_args):
    """Every 2-rank case in one group (one spawn): the denoise step, the
    NeRF step, the fit pairs, `dryrun(2)` and the tiny pipeline."""
    return {"denoise": denoise_case(rank, world, *denoise_args),
            "nerf_step": nerf_step_case(rank, world, *nerf_args),
            "fits": {k: fit_pair_case(rank, world, k)
                     for k in ("nerf", "mesh", "nerf_uneven")},
            "dryrun": dryrun_case(rank, world),
            "pipeline": pipeline_case(rank, world, *pipeline_args)}


def one_rank_cases(rank, world):
    """Every 1-rank case in one group: `one_rank_case` and `dryrun(1)`."""
    return dict(one_rank_case(rank, world), dryrun=dryrun_case(rank, world))


def pipeline_case(rank, world, num_views, steps, seed):
    """The tiny pipeline sharded over the ranks (`dryrun_pipeline`); on
    rank 0 also the same request without a mesh."""
    from mvedit_tpu_torch.parallel import dryrun_pipeline
    runs = [dryrun_pipeline(_mesh(), num_views, steps, seed)]
    if rank == 0:
        runs.append(dryrun_pipeline(None, num_views, steps, seed))
    return [{"rgb": r["renders"]["rgb"],
             "sdf": r["mesh_state"]["sdf"].detach()} for r in runs]
