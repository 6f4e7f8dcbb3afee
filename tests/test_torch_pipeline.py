"""The whole `run_3d_to_3d` request, port against the JAX package, on the CPU
at the tiny configuration both runners use (`tiny_models=True`): SD-like
UNet / ControlNets / VAE / CLIP at narrow widths, 3 views, 2 diffusion
steps (1-pass, reference pairs), 64^2 renders, dense field (8, 32), NeRF
fits of 8 and 4 steps, tet 16, the grid-atlas bake at 1024^2. The JAX
runner tokenizes through `torch_tokenizer.StableHashTokenizer`, the port's
crc32 word ids (its own `HashTokenizer` hashes words with the per-process
salted `hash()`). The port gets the JAX runner's weights (bridged, the
ControlNets' zero-initialised heads jittered in both) and every random
draw of the JAX run (`torch_jax_draws.JaxDraws`).

Tolerances:
- the latents after the first timestep (the 3-view denoise on the renders
  of the first 8-step NeRF fit, the VAE round trip, the eps blend and the
  solver): within 2e-3 of their magnitude; the reference rows, which
  follow the schedule from the VAE encoding of the init renders, within
  1e-4;
- the final mesh: face counts within 10%, the vertices' mean radius
  within 2% and their bounding boxes within 0.05; the albedo atlas: mean
  |d| <= 0.05 over the texels both bake. The chains part after the first
  fit steps for a reason of the reference's own (Adam's eps of 1e-15,
  ROADMAP Queue 3), and the mesh fits amplify it; the per-module tests
  hold each step tightly.

With `debug=1` in both configs (each runner's `_cfg_from_schema`
wrapped), both requests write the per-step debug tiles: the same file
names, each tile within mean |d| <= 0.05 (the albedo's tolerance); the
port's GLB bytes equal a second port request's without them.

Also here: `PhaseTimer.steady` equal to JAX's, `trace` / `annotate`
leaving a Chrome trace that names the range; the port imports with JAX,
flax and `mvedit_tpu` blocked, and a port-only rehearsal of the branches the tiny request skips (the render-size ramp, the SRVGG enhancer, LPIPS,
decimation + texture refinement) on the CPU.
"""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mvedit_tpu.apis import Adapter3DRunner as JRunner
from mvedit_tpu.models.diffusion import schedulers as JS
from mvedit_tpu.models.mesh import Mesh as JMesh
from mvedit_tpu.utils import profiling as JP

from mvedit_tpu_torch.apis import Adapter3DRunner as TRunner
from mvedit_tpu_torch.models.diffusion import schedulers as TS
from mvedit_tpu_torch.models.diffusion.weights import torch_state_from_flax
from mvedit_tpu_torch.models.mesh import Mesh as TMesh
from mvedit_tpu_torch.utils import profiling as TP

from torch_jax_draws import JaxDraws
from torch_tokenizer import StableHashTokenizer

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torus_glb(path, nu=48, nv=12, R=0.55, r=0.22):
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, nu, endpoint=False),
                       np.linspace(0, 2 * np.pi, nv, endpoint=False),
                       indexing="ij")
    verts = np.stack([(R + r * np.cos(v)) * np.cos(u),
                      (R + r * np.cos(v)) * np.sin(u),
                      r * np.sin(v)], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, ((i + 1) % nu) * nv + j
    c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    m = TMesh(v=verts * 1.7 + 0.3, f=faces.astype(np.int32))
    m.auto_normal()
    m.write_glb(path)
    return path


def _bridge(jr, tr):
    """The JAX runner's tiny weights into the port's runner (the
    ControlNets' zero heads jittered first, in the JAX runner's cache)."""
    rng = np.random.default_rng(0)
    jm = jr.load_stable_diffusion()
    tm = tr.load_stable_diffusion()
    for mod, params, kind in ((tm.unet, jm.unet_params, "unet"),
                              (tm.vae, jm.vae_params, "vae"),
                              (tm.text, jm.text_params, "clip_text")):
        mod.load_state_dict(torch_state_from_flax(
            jax.tree_util.tree_map(np.asarray, params), kind))
    _, cps = jr.load_controlnets(("tile", "depth"))
    nets = tr.load_controlnets(("tile", "depth"))
    for kind, p, net in zip(("tile", "depth"), cps, nets):
        p = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
                x.shape).astype(np.float32), p)
        jr._cache[f"controlnet:{kind}"] = p
        net.load_state_dict(torch_state_from_flax(p, "controlnet"))


def _record(monkeypatch, module):
    """Record the outputs of `module.dpmsolver_step`."""
    calls = []
    step = module.dpmsolver_step

    def wrapped(*a, **k):
        out = step(*a, **k)
        calls.append(np.array(out[0]) if not isinstance(out[0], torch.Tensor)
                     else out[0].detach().cpu().numpy())
        return out
    monkeypatch.setattr(module, "dpmsolver_step", wrapped)
    return calls


def _debug_tiles(monkeypatch, runner, out_dir):
    """Every MVEdit config `runner` builds gets `debug=1` and `out_dir`."""
    build = type(runner)._cfg_from_schema

    def with_debug(self, *a, **k):
        return dataclasses.replace(build(self, *a, **k), debug=1,
                                   debug_dir=out_dir)
    monkeypatch.setattr(type(runner), "_cfg_from_schema", with_debug)


def test_run_3d_to_3d_matches_jax(tmp_path, monkeypatch):
    src = _torus_glb(str(tmp_path / "torus.glb"))
    jr = JRunner(tiny_models=True, seed=0)
    jr.tokenizer = StableHashTokenizer()
    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    _bridge(jr, tr)
    # the debug tiles on in both requests, through their configs
    for runner, tag in ((jr, "jax"), (tr, "port")):
        _debug_tiles(monkeypatch, runner, str(tmp_path / f"debug_{tag}"))
    calls_j, calls_t = _record(monkeypatch, JS), _record(monkeypatch, TS)
    out_j = jr.run_3d_to_3d(src, "a red torus", seed=1,
                            out_path=str(tmp_path / "jax.glb"))
    ingp = jr._mvedit_cfg(3, 2, 4, 8).ingp
    out_t = tr.run_3d_to_3d(src, "a red torus", seed=1,
                            out_path=str(tmp_path / "port.glb"),
                            draws=JaxDraws(jax.random.PRNGKey(1), ingp))
    # the latents after the first timestep (the first call; the second is
    # the reference rows')
    assert len(calls_t) == len(calls_j) == 4
    lat_j, lat_t = calls_j[0], calls_t[0]
    assert np.isfinite(lat_j).all()
    np.testing.assert_allclose(lat_t, lat_j, atol=2e-3 * np.abs(lat_j).max())
    # the reference rows follow the schedule from the VAE encoding of the
    # init renders: within 1e-4 of their magnitude
    np.testing.assert_allclose(calls_t[1], calls_j[1],
                               atol=1e-4 * np.abs(calls_j[1]).max())

    mj, mt = out_j["mesh"], out_t["mesh"]
    assert mj is not None and mt is not None
    assert abs(len(mt.f) - len(mj.f)) <= 0.1 * len(mj.f)
    rj = np.linalg.norm(mj.v - mj.v.mean(0), axis=-1).mean()
    rt = np.linalg.norm(mt.v - mt.v.mean(0), axis=-1).mean()
    assert abs(rt - rj) <= 0.02 * rj
    np.testing.assert_allclose(mt.v.min(0), mj.v.min(0), atol=0.05)
    np.testing.assert_allclose(mt.v.max(0), mj.v.max(0), atol=0.05)
    assert mt.albedo.shape == mj.albedo.shape == (1024, 1024, 3)
    assert np.isfinite(mt.albedo).all()
    assert np.abs(mt.albedo - mj.albedo).mean() <= 0.05
    # the GLBs read back, in either package
    for path in ("jax.glb", "port.glb"):
        for load in (TMesh.load, JMesh.load):
            m = load(str(tmp_path / path))
            assert len(m.f) > 0 and m.albedo is not None

    # the debug tiles: one a view a step, the same names in both packages,
    # each within the albedo's mean |d| <= 0.05
    names = sorted(os.listdir(tmp_path / "debug_jax"))
    assert names == sorted(os.listdir(tmp_path / "debug_port"))
    # 3 views x (the first fit and 2 timesteps)
    assert names == [f"{i:03d}_{v:03d}.png" for i in range(3)
                     for v in range(3)]
    for name in names:
        a, b = (np.asarray(Image.open(tmp_path / d / name), np.float32)
                / 255 for d in ("debug_jax", "debug_port"))
        assert a.shape == b.shape
        assert np.abs(a - b).mean() <= 0.05, name
    # the port's GLB is the same without them
    monkeypatch.setattr(type(tr), "_cfg_from_schema",
                        type(tr)._cfg_from_schema)
    tr.run_3d_to_3d(src, "a red torus", seed=1,
                    out_path=str(tmp_path / "port_nodebug.glb"),
                    draws=JaxDraws(jax.random.PRNGKey(1), ingp))
    assert (tmp_path / "port_nodebug.glb").read_bytes() == \
        (tmp_path / "port.glb").read_bytes()


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with `jax`, `jaxlib`, `flax`,
    `optax` and `mvedit_tpu` blocked, and `gradio` and `dearpygui` too; the
    tiny request then runs to its GLB, decimation included, and so does a
    tiny `run_retex` with the front view and IP-Adapter. GRM with the
    gaussian renderer, TSDF fusion with marching cubes, and
    `parallel.dryrun` over a 1-rank gloo group run there too; `build_app`
    raises `ImportError` and a `MeshViewer` frame renders. The last
    slice's names (`steady`, `trace`, `annotate`, `fill_holes`,
    `weld_vertices`, `render_mesh_attrs`, `mse_loss`, `get_cam_rays`)
    import and run there too."""
    code = r'''
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "mvedit_tpu",
                   "gradio", "dearpygui"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import mvedit_tpu_torch
for m in pkgutil.walk_packages(mvedit_tpu_torch.__path__, "mvedit_tpu_torch."):
    importlib.import_module(m.name)
import numpy as np, tempfile, os
from mvedit_tpu_torch.apis import Adapter3DRunner
from mvedit_tpu_torch.models.mesh import Mesh
d = tempfile.mkdtemp()
u, v = np.meshgrid(np.linspace(0, 6.283, 24, endpoint=False),
                   np.linspace(0, 6.283, 8, endpoint=False), indexing="ij")
verts = np.stack([(0.55 + 0.22 * np.cos(v)) * np.cos(u),
                  (0.55 + 0.22 * np.cos(v)) * np.sin(u),
                  0.22 * np.sin(v)], -1).reshape(-1, 3).astype(np.float32)
i, j = np.meshgrid(np.arange(24), np.arange(8), indexing="ij")
a, b = i * 8 + j, ((i + 1) % 24) * 8 + j
c, e = ((i + 1) % 24) * 8 + (j + 1) % 8, i * 8 + (j + 1) % 8
f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                    np.stack([a, c, e], -1).reshape(-1, 3)]).astype(np.int32)
Mesh(v=verts, f=f).write_glb(os.path.join(d, "in.glb"))
out = Adapter3DRunner(tiny_models=True, device="cpu").run_3d_to_3d(
    os.path.join(d, "in.glb"), "a torus", seed=0, tet_resolution=32,
    out_path=os.path.join(d, "out.glb"))
assert len(Mesh.load(os.path.join(d, "out.glb")).f) > 0
img = np.random.default_rng(0).random((32, 32, 3)).astype(np.float32)
rt = Adapter3DRunner(tiny_models=True, device="cpu").run_retex(
    os.path.join(d, "in.glb"), "a torus", seed=0, steps=4,
    n_inverse_steps=2, front_view_id=0, in_image=img,
    out_path=os.path.join(d, "retex.glb"))
assert Mesh.load(os.path.join(d, "retex.glb")).albedo is not None
new = {"mvedit_tpu_torch." + m for m in (
    "models.grm", "models.mesh.gaussians", "models.mesh.tsdf",
    "ops.marching_cubes", "parallel", "parallel.sharded", "testing",
    "ops.morton", "utils.vdb", "utils.debug_viz", "apis.viewer",
    "apis.webui", "tools.generate_tets", "tools.glb_to_obj",
    "tools.kitti_preproc", "tools.checkpoint_cleaner",
    "tools.convert_weights", "tools.example_api_local")}
assert new <= set(sys.modules), new - set(sys.modules)
from mvedit_tpu_torch.apis import viewer, webui
try:
    webui.build_app(None)
    raise AssertionError("build_app ran without gradio")
except ImportError:
    pass
frame = viewer.MeshViewer(Mesh.load(os.path.join(d, "in.glb")),
                          render_size=32, device="cpu").frame(0.3)
assert frame.shape == (32, 32, 3) and (frame < 1).any()
import socket, torch, torch.distributed as dist
from mvedit_tpu_torch.models.grm import (GRMConfig, GRMEncoder,
    GaussianUpsampler, pixels_to_gaussians, plucker_rays)
from mvedit_tpu_torch.models.mesh.gaussians import (GSRasterConfig,
    render_gaussians)
from mvedit_tpu_torch.models.mesh import tsdf_rgbd_to_mesh
from mvedit_tpu_torch.ops.marching_cubes import extract_geometry
poses = torch.tensor([[[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.0]]] * 2)
intr = torch.tensor([[32.0, 32.0, 16.0, 16.0]] * 2)
with torch.no_grad():
    feat = GRMEncoder(GRMConfig(dim=32, depth=1, heads=4))(
        torch.rand(2, 32, 32, 3), plucker_rays(poses, intr, 32, 32))
    g = pixels_to_gaussians(GaussianUpsampler(32)(feat), poses, intr)
    img = render_gaussians(g["means"], g["scales"], g["quats"], g["colors"],
                           g["opacities"], torch.eye(3, 4), intr[0],
                           GSRasterConfig(32, 32, k_per_tile=64))
assert img["rgb"].shape == (32, 32, 3)
v, fc = extract_geometry(lambda p: 20 * (0.5 - p.norm(dim=-1)),
                         resolution=16, threshold=5.0, device="cpu")
assert len(fc) > 0
c2w = torch.eye(4)[None].repeat(2, 1, 1)
c2w[:, 2, 3] = -2.0
m = tsdf_rgbd_to_mesh(torch.rand(2, 16, 16, 3), torch.full((2, 16, 16), 2.0),
                      c2w, intr / 2, voxel_resolution=16, prune_thr=0,
                      mesh_reduction=0.0, device="cpu")
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=1, rank=0)
from mvedit_tpu_torch.parallel import dryrun
dryrun(1)
dist.destroy_process_group()
from mvedit_tpu_torch.utils.profiling import PhaseTimer, annotate, trace
from mvedit_tpu_torch.ops import fill_holes
from mvedit_tpu_torch.native import weld_vertices
from mvedit_tpu_torch.models.mesh import RasterConfig, render_mesh_attrs
from mvedit_tpu_torch.models.losses import mse_loss
from mvedit_tpu_torch.utils.geometry import get_cam_rays
pt = PhaseTimer()
pt.durations["p"], pt.sigs["p"] = [3.0, 1.0, 2.0], [None] * 3
assert pt.steady("p") == 1.5
with trace(os.path.join(d, "trace")):
    with annotate("x"):
        fill_holes(torch.rand(8, 8))
assert os.listdir(os.path.join(d, "trace"))
wv, wf = weld_vertices(np.concatenate([verts, verts]),
                       np.concatenate([f, f + len(verts)]))
assert len(wv) == len(verts) and (wf[:len(f)] == wf[len(f):]).all()
r = render_mesh_attrs(torch.from_numpy(verts), torch.from_numpy(f),
                      torch.ones(len(f), dtype=torch.bool), poses[0],
                      intr[0], RasterConfig(32, 32),
                      {"xyz": torch.from_numpy(verts)})
assert r["xyz"].shape == (32, 32, 3)
assert float(mse_loss(torch.ones(3), torch.zeros(3))) == 1.0
assert get_cam_rays(poses, intr, 4, 4)[1].shape == (2, 4, 4, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "mvedit_tpu"))
assert not bad, bad
'''
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.parametrize("case", ["sigs", "skip_first", "nothing_warm",
                                  "mixed"])
def test_phase_timer_steady_matches_jax(case):
    """`tests/test_evaluation.py::test_phase_timer_signature_steady`'s
    three cases through both timers, and ticks of mixed sigs recorded by
    the port's `tick`: equal results."""
    d, s, skip = {
        "sigs": ([30.0, 1.0, 1.2, 40.0, 2.0, 1.1],
                 [("a",), ("a",), ("a",), ("b",), ("b",), ("a",)], 1),
        "skip_first": ([30.0, 1.0, 3.0], [None, None, None], 1),
        "nothing_warm": ([30.0], [("a",)], 1),
        "mixed": (None, [(64, 3), None, (64, 3), (128, 3), (64, 3), None,
                         (128, 3), None], 2)}[case]
    tt = TP.PhaseTimer()
    if d is None:
        tt.mark()
        for sg in s:
            tt.tick("p", torch.ones(2), sig=sg)
        d = list(tt.durations["p"])
        assert tt.sigs["p"] == s and tt.counts["p"] == len(s)
    else:
        tt.durations["p"], tt.sigs["p"] = list(d), list(s)
    jt = JP.PhaseTimer()
    jt.durations["p"], jt.sigs["p"] = list(d), list(s)
    assert tt.steady("p", skip) == jt.steady("p", skip)
    assert tt.steady("absent") is None and jt.steady("absent") is None
    if case == "nothing_warm":
        assert tt.steady("p") is None
    elif case != "mixed":
        assert tt.steady("p") == {"sigs": 1.15, "skip_first": 2.0}[case]


def test_trace_and_annotate_write_a_named_range(tmp_path):
    """A tiny op inside `annotate("x")` inside `trace(dir)`: the Chrome
    trace under dir names the range."""
    with TP.trace(str(tmp_path)) as log_dir:
        with TP.annotate("x"):
            torch.ones(64).cumsum(0)
    assert log_dir == str(tmp_path)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    import json
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "x" in names


def test_pipeline_branches_rehearsal():
    """Port only, on the CPU: the branches of `MVEdit3DPipeline.__call__`
    the tiny request skips, on the tiny models at 64^2: the 16 -> 32 -> 64
    render-size ramp with the SRVGG enhancer, the patch LPIPS in both fits
    (VGG16 at its published widths, 16^2 patches), the 2-pass denoise,
    view pruning 6 -> 4 -> 3, and decimation + texture refinement at tet
    32. The phase timer sees every phase, in one step one after another,
    and the bake's spans under `bake`; the bake writes a finite atlas."""
    from mvedit_tpu_torch.models.losses import lpips_init
    from mvedit_tpu_torch.pipelines.mvedit_3d import MVEdit3DPipeline
    from mvedit_tpu_torch.utils import profiling as P
    from mvedit_tpu_torch.native import native_available
    tr = TRunner(tiny_models=True, seed=0, device="cpu")
    m = tr.load_stable_diffusion()
    m.controlnets = tr.load_controlnets(("tile", "depth"))
    m.segment_fn = None
    m.lpips_params = lpips_init(torch.Generator().manual_seed(0))
    m.enhance_fn = tr.load_image_enhancer()
    cfg = tr._mvedit_cfg(6, 4, 2, 4, mode="2-pass", render_size_ramp=True,
                         use_lpips=True, tet_resolution=32,
                         tet_init_inverse_steps=2, mid_num_views=4,
                         min_num_views=3, mesh_simplify_texture_steps=2)
    assert cfg.render_sizes() == (16, 32, 64) and cfg.mesh_reduction == 1.0
    cfg = type(cfg)(**{**cfg.__dict__, "mesh_reduction": 0.5})
    from mvedit_tpu_torch.apis import cameras as C
    from mvedit_tpu_torch.utils import camera as cu
    rng = np.random.default_rng(0)
    poses, intr = C.surround_rig(6, 3.2, 40, -0.2, 0.5, 64, rng=rng)
    lights, _ = cu.light_sampling(poses, rng=rng)
    mesh = types.SimpleNamespace(v=np.random.default_rng(1).normal(
        size=(200, 3)).astype(np.float32) * 0.3, f=np.random.default_rng(2)
        .integers(0, 200, (300, 3)).astype(np.int32), vc=None)
    init = tr.load_init_mesh(mesh, poses, intr, 64, lights)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    targets = {"images": init["images"], "masks": init["masks"],
               "poses": t(poses), "intrinsics": t(intr),
               "cam_weights": torch.ones(6), "cam_lights": t(lights)}
    pos, neg = tr.encode_prompt(m, ["a rock"] * 6, [""] * 6)
    pt = P.PhaseTimer()
    P.set_phase_timer(pt)
    try:
        out = MVEdit3DPipeline(m, cfg)(
            targets, pos.clone(), neg.clone(),
            generator=torch.Generator().manual_seed(0))
    finally:
        P.set_phase_timer(None)
    assert set(pt.totals) == {"denoise_p1+vae_dec", "nerf_fit", "mesh_fit",
                              "render_all", "denoise_p2+vae_enc+solver",
                              "bake"}
    # progress 0, 0.25 at 16^2, 0.5 at 32^2; 0.75 and 1 on the mesh
    assert pt.counts["nerf_fit"] == 3 and pt.counts["mesh_fit"] == 2
    # the phases are the roots, a step's in order with no gap between
    phases = [s for s in pt.spans if s.parent is None]
    assert [s.name for s in phases] == [
        "nerf_fit", "render_all"] + [
        "denoise_p1+vae_dec", "nerf_fit", "render_all",
        "denoise_p2+vae_enc+solver"] * 2 + [
        "denoise_p1+vae_dec", "mesh_fit", "render_all",
        "denoise_p2+vae_enc+solver"] * 2 + ["bake"]
    for a, b in zip(phases, phases[1:]):
        assert a.end <= b.start < a.end + 0.25, (a.name, b.name)
    assert [s.end - s.start for s in phases if s.name == "nerf_fit"] \
        == pt.durations["nerf_fit"]
    bake = pt.spans.index(phases[-1])
    assert {s.name for s in pt.spans if s.parent == bake} == {
        "bake.extract", "bake.uv", "bake.texture"} | (
        {"bake.decimate", "bake.refine"} if native_available() else set())
    assert out["renders"]["rgb"].shape[0] == 3
    mesh = out["mesh"]
    assert mesh is not None and np.isfinite(mesh.albedo).all()
    if native_available():
        assert len(mesh.f) <= 0.55 * int(out["mesh_state"]["sdf"].numel())
