"""Desktop mesh / NeRF viewers (counterpart of `mvedit_tpu/apis/viewer.py`;
dearpygui optional).

The role of the reference's dearpygui GUIs (`lib/core/ssdnerf_gui.py:102`,
the orbit-camera NeRF viewer with sampling controls; `lib/core/
mesh_gui.py:78`, the mesh viewer). Without dearpygui, frames, turntables
and the exports still work headlessly (the render path the GUIs drive);
`run_gui` raises `ImportError`. `MeshViewer` renders on the card (the
raster selection kernel, one launch a frame) unless `device="cpu"`;
`SSDNeRFViewer` evaluates its density on `device` for the exports.
"""
import numpy as np
import torch

__all__ = ["OrbitViewer", "SSDNeRFViewer", "MeshViewer"]

# density points a `density_fn` call takes in the exports
_CHUNK = 262144


class OrbitViewer:
    """Headless-capable orbit viewer around a render callback.

    render_fn(pose (3,4), intrinsics (4,)) -> (H, W, 3) float [0,1].
    """

    def __init__(self, render_fn, intrinsics, distance=2.5, elev=0.2):
        self.render_fn = render_fn
        self.intrinsics = np.asarray(intrinsics, np.float32)
        self.distance = distance
        self.elev = elev

    def frame(self, azimuth, elev=None, distance=None):
        from ..utils.camera import get_pose_from_angles
        pose = get_pose_from_angles(
            np.asarray([azimuth], np.float32),
            np.asarray([elev if elev is not None else self.elev],
                       np.float32),
            distance or self.distance)[0, :3]
        return np.asarray(self.render_fn(pose, self.intrinsics))

    def render_turntable(self, num_frames=60, path=None, fps=30):
        from ..utils.video import write_video
        frames = [self.frame(a) for a in
                  np.linspace(0, 2 * np.pi, num_frames, endpoint=False)]
        if path:
            return write_video(np.stack(frames), path, fps)
        return np.stack(frames)

    def run_gui(self, width=800, height=800):
        """Interactive dearpygui window (requires dearpygui)."""
        try:
            import dearpygui.dearpygui as dpg
        except ImportError as e:
            raise ImportError(
                "dearpygui not installed; use render_turntable() for "
                "headless orbit rendering") from e
        dpg.create_context()
        state = {"azi": 0.0, "elev": self.elev, "dist": self.distance}

        def redraw():
            img = self.frame(state["azi"], state["elev"], state["dist"])
            dpg.set_value("tex", np.asarray(
                np.concatenate([img, np.ones_like(img[..., :1])], -1),
                np.float32).ravel())

        h, w = self.frame(0.0).shape[:2]
        with dpg.texture_registry():
            dpg.add_raw_texture(w, h, np.zeros((h * w * 4,), np.float32),
                                tag="tex", format=dpg.mvFormat_Float_rgba)
        with dpg.window(label="mvedit_tpu_torch viewer"):
            dpg.add_image("tex")
            for key, lo, hi in (("azi", 0.0, 6.283), ("elev", -1.2, 1.2),
                                ("dist", 1.2, 5.0)):
                dpg.add_slider_float(
                    label=key, default_value=state[key], min_value=lo,
                    max_value=hi,
                    callback=lambda s, v, k=key: (state.__setitem__(k, v),
                                                  redraw()))
        redraw()
        dpg.create_viewport(title="mvedit_tpu_torch", width=width,
                            height=height)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.start_dearpygui()
        dpg.destroy_context()


class SSDNeRFViewer(OrbitViewer):
    """SSDNeRF sampling / export viewer (role of the reference's
    `lib/core/ssdnerf_gui.py:102-1100` dearpygui tool): orbit rendering of
    a sampled scene code plus the GUI's actions as a headless API:
    Generate (text / uncond sampling), save / load scene code, export mesh
    (marching cubes at a chosen resolution / threshold), export volume
    (OpenVDB), screenshot, multi-view grid, and turntable video. `run_gui`
    adds the interactive dearpygui layer when dearpygui is installed.

    sample_fn(prompt, negative_prompt, seed, steps, cfg_scale) ->
        (code, render_fn), typically wrapping
        `gaussian_diffusion.sample_from_noise` and a triplane decoder.
    density_fn(xyz (n, 3) on `device`) -> sigma (n,) for the exports,
    called in chunks of `_CHUNK` points.
    """

    def __init__(self, sample_fn, intrinsics, density_fn=None,
                 distance=2.5, elev=0.2, device="cuda"):
        super().__init__(lambda pose, intr: np.zeros((8, 8, 3)),
                         intrinsics, distance, elev)
        self.sample_fn = sample_fn
        self.density_fn = density_fn
        self.device = torch.device(device)
        self.code = None
        self.last_args = None

    # --- GUI actions (all usable headlessly) ---------------------------
    def generate(self, prompt="", negative_prompt="", seed=42, steps=50,
                 cfg_scale=7.0):
        """'Generate' button (ssdnerf_gui.py:340-441)."""
        self.last_args = dict(prompt=prompt,
                              negative_prompt=negative_prompt, seed=seed,
                              steps=steps, cfg_scale=cfg_scale)
        self.code, self.render_fn = self.sample_fn(
            prompt, negative_prompt, seed, steps, cfg_scale)
        return self.code

    def save_scene(self, path):
        """'Save scene' (ssdnerf_gui.py:449-462): code + sampling args."""
        code = self.code.detach().cpu().numpy() \
            if torch.is_tensor(self.code) else np.asarray(self.code)
        np.savez(path, code=code,
                 **{f"arg_{k}": v for k, v in (self.last_args or {}).items()})

    def load_scene(self, path, make_render_fn):
        """'Load scene' (ssdnerf_gui.py:465-489)."""
        d = np.load(path, allow_pickle=True)
        self.code = d["code"]
        self.render_fn = make_render_fn(self.code)
        return self.code

    def export_mesh(self, path, resolution=256, threshold=10.0):
        """'Export mesh' (ssdnerf_gui.py:494-517): marching cubes on the
        density field."""
        if self.density_fn is None:
            raise ValueError("density_fn required for mesh export")
        from ..models.mesh import Mesh
        from ..ops.marching_cubes import extract_geometry
        verts, faces = extract_geometry(self.density_fn,
                                        resolution=resolution,
                                        threshold=threshold,
                                        chunk=_CHUNK, device=self.device)
        mesh = Mesh(v=np.asarray(verts, np.float32),
                    f=np.asarray(faces, np.int32))
        mesh.auto_normal()
        mesh.write(path)
        return mesh

    @torch.no_grad()
    def _density_grid(self, resolution=256, bound=1.0):
        """The density on the (resolution,)^3 lattice over [-bound,
        bound]^3, X-Y-Z indexed, as a host float32 array."""
        ax = np.linspace(-bound, bound, resolution, dtype=np.float32)
        pts = torch.from_numpy(np.stack(np.meshgrid(ax, ax, ax,
                                                    indexing="ij"),
                                        -1).reshape(-1, 3)).to(self.device)
        sigma = torch.cat([self.density_fn(pts[i:i + _CHUNK])
                           .reshape(-1).float()
                           for i in range(0, pts.shape[0], _CHUNK)])
        return sigma.cpu().numpy().reshape(resolution, resolution,
                                           resolution)

    def export_vdb(self, path, resolution=256, sparse_threshold=0.01,
                   bound=1.0):
        """'Export volume' (ssdnerf_gui.py:1058): density grid -> OpenVDB."""
        if self.density_fn is None:
            raise ValueError("density_fn required for volume export")
        from ..utils.vdb import save_vdb
        sigma = self._density_grid(resolution, bound)
        save_vdb(path, sigma, sparse_threshold)
        return sigma

    def export_screenshot(self, path, azimuth=0.0):
        """'Export screenshot' (ssdnerf_gui.py:524-527)."""
        img = self.frame(azimuth)
        _write_png(path, img)
        return img

    def export_multi_view(self, path_pattern, num_views=6):
        """'Export multi-view' (ssdnerf_gui.py:528-532)."""
        outs = []
        for i, a in enumerate(np.linspace(0, 2 * np.pi, num_views,
                                          endpoint=False)):
            img = self.frame(a)
            _write_png(path_pattern.format(i), img)
            outs.append(img)
        return np.stack(outs)

    def export_video(self, path, num_frames=60, fps=30):
        """'Export video' (ssdnerf_gui.py:533-541)."""
        return self.render_turntable(num_frames, path, fps)

    def run_gui(self, width=800, height=800):
        try:
            import dearpygui.dearpygui as dpg  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "dearpygui not installed; the generate/save_scene/"
                "export_* methods cover the GUI actions headlessly") from e
        if self.code is None:
            self.generate()
        return super().run_gui(width, height)


class MeshViewer(OrbitViewer):
    """Textured-mesh orbit viewer (role of `lib/core/mesh_gui.py:78-433`):
    renders a `Mesh` with lambertian shading through the tile-binned
    rasterizer on `device` (the reference's default raster capacities:
    a mesh that overflows a tile loses triangles there,
    `rasterize.tile_load` counts them); headless frames / turntable plus
    the optional dearpygui window from OrbitViewer."""

    def __init__(self, mesh, render_size=512, fov_deg=40.0, distance=2.5,
                 elev=0.2, ambient=0.3, device="cuda"):
        from ..models.mesh import RasterConfig, render_views
        from ..models.mesh.texture import _sample_level
        from ..utils.camera import intrinsics_from_fov

        dev = torch.device(device)
        self.raster_cfg = rc = RasterConfig(height=render_size,
                                            width=render_size)
        self.verts = v = torch.as_tensor(np.asarray(mesh.v, np.float32),
                                         device=dev)
        self.faces = f = torch.as_tensor(np.asarray(mesh.f, np.int64),
                                         device=dev)
        fm = torch.ones((len(mesh.f),), dtype=torch.bool, device=dev)
        tex = None if mesh.albedo is None else torch.as_tensor(
            np.asarray(mesh.albedo, np.float32), device=dev)
        uv_attr = None
        if mesh.vt is not None and len(mesh.vt) == len(mesh.v):
            uv_attr = torch.as_tensor(np.asarray(mesh.vt, np.float32),
                                      device=dev)

        @torch.no_grad()
        def render(pose, intr):
            pose = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
            out = render_views(v, f, fm, pose[None],
                               torch.as_tensor(np.asarray(intr, np.float32),
                                               device=dev)[None], rc,
                               vert_attrs={"uv": uv_attr}
                               if uv_attr is not None else None)
            n = out["normal"][0]
            alpha = out["alpha"][0]
            light = pose[:3, 3]
            light = light / torch.linalg.norm(light).clamp(min=1e-6)
            lam = (n * light).sum(-1, keepdim=True).clamp(min=0.0) \
                * (1 - ambient) + ambient
            if tex is not None and uv_attr is not None:
                base = _sample_level(tex, out["uv"][0])
            else:
                base = torch.ones_like(n) * 0.7
            rgb = (base * lam).clamp(0, 1)
            return (rgb * alpha + (1 - alpha)).cpu().numpy()

        intr = intrinsics_from_fov(fov_deg, render_size, render_size)
        super().__init__(render, intr, distance, elev)


def _write_png(path, img):
    from PIL import Image
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
