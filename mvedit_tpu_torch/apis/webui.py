"""Gradio Web UI (counterpart of `mvedit_tpu/apis/webui.py`): the tab tree,
the named API endpoints and the send-to wiring.

The reference's `app.py:94-267` + `lib/core/webui/`: the tab structure
(Text-to-3D {StableSSDNeRF, Text-to-Image-to-3D}, Image-to-3D {Zero123++
v1.1, v1.2}, 3D-to-3D {MVEdit, MVEdit Instruct}, Re-Texturing {MVEdit,
MVEdit Instruct}, Tools {Export video}) with the reference's named api
endpoints and its full positional input contracts, generated from the
`apis/parameters.py` schema dicts, so gradio_client scripts written
against the reference keep working:

  text_to_3d_stablessdnerf, text_to_3d_stablessdnerf_to_mesh, text_to_img,
  image_segmentation, img_to_3d_1_1_zero123plus,
  img_to_3d_1_1_zero123plus_to_mesh, img_to_3d_1_2_zero123plus,
  img_to_3d_1_2_zero123plus_to_mesh, 3d_preproc, 3d_to_3d_mvedit,
  3d_to_3d_mvedit_instruct, retex_mvedit, retex_mvedit_instruct,
  mesh_to_video

Positional contracts (the reference's tab builders at
`lib/core/webui/tab_*.py` compose each endpoint's inputs as
[seed, media inputs...] + schema-ordered widgets + trailing extras):

- each schema widget list is the schema dict's keys in order, filtered to
  the keys that get widgets at the current `advanced` setting: the
  reference's `[var_dict[k] for k in defaults.keys() if k not in
  default_var_dict]` (tab_img_to_3d.py:111-116, tab_3d_to_3d.py:91-96,
  tab_retexturing.py:93-99);
- superres widgets follow (create_superres_opts), then trailing extras
  (Zero123++ output images for img_to_3d; in_image for non-instruct
  retex).

`endpoint_signature(name, advanced)` returns the ordered input-name list
and `endpoint_adapters(runner, advanced)` the callables each named
endpoint runs, {api_name: fn(*positional values)}; both import without
gradio, which only `build_app` needs (it raises `ImportError` without it).
Without gradio, `apis/server.py::ApiServer` serves the same endpoints as
HTTP JSON.
"""
import json
import os
import tempfile
import uuid

import numpy as np
import torch

from . import parameters as P

__all__ = ["build_app", "endpoint_adapters", "endpoint_signature",
           "schema_widget_keys", "ENDPOINT_NAMES"]

# widget key sets at advanced=False — the reference's basic opts
# (create_prompt_opts + create_base_opts, shared_opts.py:7-73); at
# advanced=True every schema key gets a widget (tab builders create the
# aux/advanced/loss/optimization blocks covering the rest)
_NERF_MESH_BASIC = ("prompt", "negative_prompt", "scheduler", "steps",
                    "denoising_strength", "random_init", "cfg_scale")
_SUPERRES_BASIC = ("do_superres", "use_ip_adapter", "scheduler", "steps",
                   "denoising_strength", "random_init", "cfg_scale")
_RETEX_BASIC = _NERF_MESH_BASIC + ("force_auto_uv",)
_IMAGE_BASIC = ("width", "height", "prompt", "negative_prompt",
                "scheduler", "steps", "cfg_scale")
# stablessdnerf: prompt opts + create_stablessdnerf_opts (scheduler/steps/
# cfg_scale; denoising_strength=None suppressed; render_bs never a widget)
_SSDNERF_KEYS = ("prompt", "negative_prompt", "scheduler", "steps",
                 "cfg_scale")

SCHEDULERS = ["DPMSolverMultistep", "DPMSolverMultistepKarras",
              "DPMSolverSDE", "DPMSolverSDEKarras",
              "EulerAncestralDiscrete", "DDIM"]

ENDPOINT_NAMES = [
    "text_to_3d_stablessdnerf", "text_to_3d_stablessdnerf_to_mesh",
    "text_to_img", "image_segmentation",
    "img_to_3d_1_1_zero123plus", "img_to_3d_1_1_zero123plus_to_mesh",
    "img_to_3d_1_2_zero123plus", "img_to_3d_1_2_zero123plus_to_mesh",
    "3d_preproc", "3d_to_3d_mvedit", "3d_to_3d_mvedit_instruct",
    "retex_mvedit", "retex_mvedit_instruct", "mesh_to_video",
]


def schema_widget_keys(defaults, basic, advanced):
    """Schema-ordered keys that become UI widgets (= positional inputs)."""
    if advanced:
        return list(defaults.keys())
    return [k for k in defaults.keys() if k in basic]


def endpoint_signature(name, advanced=False):
    """Ordered positional input names of a named API endpoint (the public
    contract; reference composition cited in the module docstring)."""
    nm = schema_widget_keys(P.nerf_mesh_defaults, _NERF_MESH_BASIC,
                            advanced)
    rt = schema_widget_keys(P.retex_defaults, _RETEX_BASIC, advanced)
    sr = ["superres_" + k for k in schema_widget_keys(
        P.superres_defaults, _SUPERRES_BASIC, advanced)]
    im = schema_widget_keys(P.image_defaults, _IMAGE_BASIC, advanced)
    sigs = {
        "text_to_3d_stablessdnerf": ["seed"] + list(_SSDNERF_KEYS),
        "text_to_3d_stablessdnerf_to_mesh": ["seed", "triplane"] + nm + sr,
        "text_to_img": ["seed"] + im,
        "image_segmentation": ["image"],
        "img_to_3d_1_1_zero123plus": ["seed", "image"],
        "img_to_3d_1_2_zero123plus": ["seed", "image"],
        "img_to_3d_1_1_zero123plus_to_mesh":
            ["seed", "image"] + nm + sr + [f"view_{i}" for i in range(6)],
        # v1.2 predicts normals: 6 RGB + 6 normal passes
        # (tab_img_to_3d.py:88-93 create_passes x2)
        "img_to_3d_1_2_zero123plus_to_mesh":
            ["seed", "image"] + nm + sr + [f"view_{i}" for i in range(6)]
            + [f"normal_{i}" for i in range(6)],
        "3d_preproc": ["mesh"],
        "3d_to_3d_mvedit": ["seed", "mesh", "front_view_id"] + nm + sr,
        "3d_to_3d_mvedit_instruct":
            ["seed", "mesh", "front_view_id"] + nm + sr,
        "retex_mvedit":
            ["seed", "mesh", "front_view_id"] + rt + sr + ["in_image"],
        "retex_mvedit_instruct": ["seed", "mesh", "front_view_id"] + rt + sr,
        "mesh_to_video": ["mesh", "front_view_id", "distance", "elevation",
                          "fov", "length", "resolution", "lossless",
                          "layer"],
    }
    return sigs[name]


def _split_args(names, args):
    """(names, values) -> (main kwargs, superres kwargs) dicts."""
    kw, sr = {}, {}
    for k, v in zip(names, args):
        if k.startswith("superres_"):
            sr[k[len("superres_"):]] = v
        else:
            kw[k] = v
    return kw, sr


def _superres_arg(sr):
    """superres widget dict -> runner `superres=` kwarg (False or a
    proc_texture_superres override dict)."""
    if not sr or not sr.get("do_superres"):
        return False
    out = {}
    if sr.get("steps") is not None:
        out["steps"] = int(sr["steps"])
    if sr.get("use_ip_adapter") is not None:
        out["use_ip_adapter"] = bool(sr["use_ip_adapter"])
    return out or True


def _cache_dir():
    d = os.path.join(tempfile.gettempdir(), "mvedit_webui")
    os.makedirs(d, exist_ok=True)
    return d


def _out_path(suffix=".glb"):
    return os.path.join(_cache_dir(), f"output_{uuid.uuid4()}{suffix}")


def _img01(image):
    return np.asarray(image, np.float32) / 255.0


def _host(x):
    """A runner output (a tensor on any device, or an array) as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _schema_kwargs(kw, schema, explicit=()):
    """Filter widget values to the schema keys the runner consumes as
    **kwargs (everything except the explicitly-passed basics and the
    adapter's own `explicit` keys)."""
    skip = {"prompt", "negative_prompt", "steps", "seed", *explicit}
    return {k: v for k, v in kw.items()
            if k in schema and k not in skip and v is not None}


# --------------------------------------------------------------------------
# widget construction (shared_opts.py analog, generated from the schema)
# --------------------------------------------------------------------------

_DROPDOWNS = {
    "scheduler": SCHEDULERS,
    "mvedit_mode": ["1-pass", "2-pass"],
    "patch_size": [128, 256, 512],
    "ingp_resolution": [320, 512],
    "tet_resolution": [128, 256],
    "layer": ["RGB", "Normal"],
}
_SLIDERS = {  # key: (min, max, step)
    "steps": (1, 64, 1), "denoising_strength": (0.0, 1.0, 0.01),
    "cfg_scale": (0.0, 30.0, 0.5), "width": (64, 2048, 8),
    "height": (64, 2048, 8), "max_num_views": (16, 256, 1),
    "min_num_views": (1, 32, 1), "diff_bs": (1, 32, 1),
    "patch_bs_nerf": (1, 16, 1), "render_bs": (1, 32, 1),
    "patch_bs": (1, 32, 1), "alpha_soften": (0.0, 0.1, 0.001),
    "normal_reg_weight": (0.0, 10.0, 0.1),
    "start_entropy_weight": (0.0, 10.0, 0.1),
    "end_entropy_weight": (0.0, 10.0, 0.1), "entropy_d": (0.0, 0.1, 0.001),
    "mesh_smoothness": (0.0, 4.0, 0.1), "n_inverse_steps": (0, 1024, 1),
    "init_inverse_steps": (0, 1024, 1),
    "tet_init_inverse_steps": (0, 1024, 1), "start_lr": (0.0, 0.1, 0.001),
    "end_lr": (0.0, 0.1, 0.001), "lr": (0.0, 0.1, 0.001),
    "distance": (1.0, 10.0, 0.1), "elevation": (-179, 179, 1.0),
    "fov": (10.0, 70.0, 1.0), "length": (1, 20, 0.5),
    "resolution": (64, 1024, 8),
}
_CHECKBOXES = ("random_init", "do_superres", "use_ip_adapter",
               "force_auto_uv", "lossless")
_TEXTS = ("prompt", "negative_prompt", "aux_prompt", "aux_negative_prompt",
          "checkpoint")
_LABELS = {"prompt": "Prompt", "negative_prompt": "Negative prompt",
           "do_superres": "Texture super-resolution",
           "use_ip_adapter": "Use IP-Adapter",
           "steps": "Sampling steps", "scheduler": "Sampling method",
           "cfg_scale": "CFG scale",
           "denoising_strength": "Denoising strength",
           "n_inverse_steps": "NeRF/mesh optimization steps"}


def _make_widget(gr, key, value, instruct=False):
    label = _LABELS.get(key, key.replace("_", " ").capitalize())
    if key == "prompt" and instruct:
        label = "Instruction"
    if key in _DROPDOWNS:
        choices = _DROPDOWNS[key]
        if value is None or value not in choices:
            value = choices[0]
        return gr.Dropdown(choices, value=value, label=label)
    if key in _CHECKBOXES:
        return gr.Checkbox(value=bool(value), label=label)
    if key in _SLIDERS:
        lo, hi, step = _SLIDERS[key]
        if value is None:
            value = lo
        return gr.Slider(lo, hi, value=value, step=step, label=label)
    return gr.Textbox(value="" if value is None else str(value),
                      label=label)


def _schema_block(gr, defaults, basic, advanced, overrides=None,
                  instruct=False, superres=False):
    """Create widgets for every positional schema key, in order. Returns
    {key: component}. Basic keys render inline; the rest sit in an
    'Advanced settings' accordion (shared_opts.py layout analog)."""
    vals = dict(defaults)
    vals.update(overrides or {})
    keys = schema_widget_keys(defaults, basic, advanced)
    widgets = {}
    title = ("Texture super-resolution options" if superres
             else "Advanced settings")
    adv_keys = [k for k in keys if k not in basic]
    with gr.Accordion(title, open=False) if superres else _null_ctx():
        for k in keys:
            if k in adv_keys:
                continue
            widgets[k] = _make_widget(gr, k, vals[k], instruct)
        if adv_keys:
            with gr.Accordion("Advanced settings", open=bool(advanced)):
                for k in adv_keys:
                    widgets[k] = _make_widget(gr, k, vals[k], instruct)
    return widgets


class _null_ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _ordered_inputs(widgets, defaults, basic, advanced):
    return [widgets[k] for k in schema_widget_keys(defaults, basic,
                                                   advanced)]


# --------------------------------------------------------------------------
# endpoint adapters and the app
# --------------------------------------------------------------------------

def endpoint_adapters(runner, advanced=False):
    """{api name: adapter} for every named endpoint: each adapter takes
    that endpoint's positional values (`endpoint_signature(name,
    advanced)`), calls the runner and returns what the UI shows. Needs no
    gradio."""

    def seg_fn(image):
        mask = runner.run_segmentation(_img01(image)[None, ..., :3])
        m = _host(mask[0])
        rgba = np.concatenate([_img01(image)[..., :3], m], axis=-1)
        return (np.clip(rgba, 0, 1) * 255).astype(np.uint8)

    def preproc_fn(mesh_path):
        out = _out_path(".glb")
        pre = runner.run_mesh_preproc(mesh_path, out_path=out)
        state = json.dumps({
            "mesh_path": out,
            "center": np.asarray(pre["center"]).tolist(),
            "scale": float(np.asarray(pre["scale"]).reshape(-1)[0])
            if np.ndim(pre["scale"]) else float(pre["scale"])})
        return out, state, 0

    def z123_fn(version):
        def run(seed, image):
            return _host(runner.run_zero123plus(
                _img01(image)[..., :3], seed=int(seed),
                version=version)) * 255
        return run

    def img_to_3d_fn(version):
        names = endpoint_signature(
            f"img_to_3d_{version.replace('.', '_')}_zero123plus_to_mesh",
            advanced)

        def run(*args):
            kw, sr = _split_args(names, args)
            out = _out_path(".glb")
            runner.run_zero123plus_to_mesh(
                _img01(kw["image"])[..., :3], seed=int(kw["seed"]),
                out_path=out, version=version,
                prompt=kw.get("prompt") or "",
                negative_prompt=kw.get("negative_prompt") or "",
                steps=int(kw["steps"]) if kw.get("steps") else None,
                superres=_superres_arg(sr),
                **_schema_kwargs(kw, P.nerf_mesh_defaults))
            return out
        return run

    def t3d_fn(instruct):
        names = endpoint_signature(
            "3d_to_3d_mvedit_instruct" if instruct else "3d_to_3d_mvedit",
            advanced)

        def run(*args):
            kw, sr = _split_args(names, args)
            out = _out_path(".glb")
            fv = kw.get("front_view_id")
            runner.run_3d_to_3d(
                kw["mesh"], kw.get("prompt") or "",
                negative_prompt=kw.get("negative_prompt") or "",
                seed=int(kw["seed"]),
                steps=int(kw["steps"]) if kw.get("steps") else None,
                instruct=instruct, out_path=out,
                front_view_id=int(fv) if fv is not None else None,
                superres=_superres_arg(sr),
                **_schema_kwargs(kw, P.nerf_mesh_defaults))
            return out
        return run

    def retex_fn(instruct):
        names = endpoint_signature(
            "retex_mvedit_instruct" if instruct else "retex_mvedit",
            advanced)

        def run(*args):
            kw, sr = _split_args(names, args)
            out = _out_path(".glb")
            fv = kw.get("front_view_id")
            in_img = kw.get("in_image")
            runner.run_retex(
                kw["mesh"], kw.get("prompt") or "",
                negative_prompt=kw.get("negative_prompt") or "",
                seed=int(kw["seed"]),
                steps=int(kw["steps"]) if kw.get("steps") else 12,
                denoising_strength=float(kw.get("denoising_strength", 0.7)),
                cfg_scale=float(kw["cfg_scale"])
                if kw.get("cfg_scale") is not None else None,
                instruct=instruct, out_path=out,
                front_view_id=int(fv) if fv is not None else None,
                in_image=_img01(in_img)[..., :3]
                if in_img is not None else None,
                superres=_superres_arg(sr),
                # the two keys passed above go once (the JAX package
                # passes them twice, and its call raises TypeError)
                **_schema_kwargs(kw, P.retex_defaults,
                                 ("denoising_strength", "cfg_scale")))
            return out
        return run

    def ssdnerf_fn(seed, prompt, negative_prompt, scheduler, steps,
                   cfg_scale):
        out = runner.run_stablessdnerf(
            prompt, seed=int(seed), cfg_scale=float(cfg_scale),
            steps=int(steps) if steps else None)
        prev = (np.clip(_host(out["preview"]), 0, 1) * 255).astype(np.uint8)
        tri = _out_path(".npy")
        np.save(tri, _host(out["code"]))
        return prev, tri

    def ssdnerf_mesh_fn(*args):
        names = endpoint_signature("text_to_3d_stablessdnerf_to_mesh",
                                   advanced)
        kw, sr = _split_args(names, args)
        out = _out_path(".glb")
        runner.run_stablessdnerf_to_mesh(
            kw.get("prompt") or "", seed=int(kw["seed"]), out_path=out,
            negative_prompt=kw.get("negative_prompt") or "",
            superres=_superres_arg(sr))
        return out

    def t2i_fn(*args):
        names = endpoint_signature("text_to_img", advanced)
        kw, _ = _split_args(names, args)
        img = runner.run_text_to_img(
            kw.get("prompt") or "",
            negative_prompt=kw.get("negative_prompt") or "",
            seed=int(kw["seed"]), width=int(kw["width"]),
            height=int(kw["height"]),
            steps=int(kw["steps"]) if kw.get("steps") else None,
            cfg_scale=float(kw["cfg_scale"]))
        return (np.clip(_host(img), 0, 1) * 255).astype(np.uint8)

    def video_fn(mesh, front_view_id, distance, elevation, fov, length,
                 resolution, lossless, layer):
        out = _out_path(".mp4")
        written = runner.run_mesh_to_video(
            mesh, out_path=out, distance=float(distance),
            elev=float(np.radians(elevation)), fov=float(fov),
            num_frames=int(float(length) * 6),
            render_size=int(resolution))
        # the file written: a GIF beside `out` where ffmpeg is missing (the
        # JAX package returns `out` all the same)
        return written or out

    return {
        "image_segmentation": seg_fn, "3d_preproc": preproc_fn,
        "img_to_3d_1_1_zero123plus": z123_fn("1.1"),
        "img_to_3d_1_2_zero123plus": z123_fn("1.2"),
        "img_to_3d_1_1_zero123plus_to_mesh": img_to_3d_fn("1.1"),
        "img_to_3d_1_2_zero123plus_to_mesh": img_to_3d_fn("1.2"),
        "3d_to_3d_mvedit": t3d_fn(False),
        "3d_to_3d_mvedit_instruct": t3d_fn(True),
        "retex_mvedit": retex_fn(False),
        "retex_mvedit_instruct": retex_fn(True),
        "text_to_3d_stablessdnerf": ssdnerf_fn,
        "text_to_3d_stablessdnerf_to_mesh": ssdnerf_mesh_fn,
        "text_to_img": t2i_fn, "mesh_to_video": video_fn}


def build_app(runner, advanced=False, debug=False):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use mvedit_tpu_torch.apis.server."
            "ApiServer for the HTTP JSON API instead") from e
    fns = endpoint_adapters(runner, advanced)

    # ---------------- layout --------------------------------------------

    send_targets = {}

    def send_buttons(gr, var, output):
        """Cross-tab "send to" buttons (app.py:188-267)."""
        with gr.Row():
            var["to_text_3d_to_3d"] = gr.Button("Send to 3D-to-3D")
            var["to_instruct_3d_to_3d"] = gr.Button(
                "Send to 3D-to-3D (instruct)")
            var["to_text_retex"] = gr.Button("Send to Re-Texturing")
            var["to_instruct_retex"] = gr.Button(
                "Send to Re-Texturing (instruct)")
            var["export_video_mesh"] = gr.Button("Export video")
        var["output"] = output

    def seed_box(gr):
        return gr.Number(value=42, precision=0, label="Seed")

    def superres_block(gr):
        return _schema_block(gr, P.superres_defaults, _SUPERRES_BASIC,
                             advanced, superres=True)

    def sr_inputs(srw):
        return _ordered_inputs(srw, P.superres_defaults, _SUPERRES_BASIC,
                               advanced)

    with gr.Blocks(title="3D-Adapter / MVEdit (PyTorch / CUDA)") as app:
        gr.Markdown("# 3D-Adapter / MVEdit")
        tab_vars = []
        with gr.Tabs():
            with gr.TabItem("Text-to-3D"):
                with gr.Tabs():
                    with gr.TabItem("StableSSDNeRF (ShapeNet Cars)/MVEdit"):
                        v = {}
                        seed = seed_box(gr)
                        ssd = {k: _make_widget(
                            gr, k, P.stablessdnerf_defaults.get(k))
                            for k in _SSDNERF_KEYS}
                        nmw = _schema_block(
                            gr, P.nerf_mesh_defaults, _NERF_MESH_BASIC,
                            advanced,
                            overrides=P.stablessdnerf_to_mesh_params)
                        srw = superres_block(gr)
                        prev = gr.Image(label="Preview")
                        tri = gr.Textbox(label="Triplane", visible=debug)
                        out3d = gr.Model3D(label="Output mesh")
                        gr.Button("Sample SSDNeRF").click(
                            fns["text_to_3d_stablessdnerf"],
                            [seed] + [ssd[k] for k in _SSDNERF_KEYS],
                            [prev, tri],
                            api_name="text_to_3d_stablessdnerf")
                        gr.Button("Refine to mesh").click(
                            fns["text_to_3d_stablessdnerf_to_mesh"],
                            [seed, tri] + _ordered_inputs(
                                nmw, P.nerf_mesh_defaults,
                                _NERF_MESH_BASIC, advanced)
                            + sr_inputs(srw),
                            [out3d],
                            api_name="text_to_3d_stablessdnerf_to_mesh")
                        v["prompt"] = ssd["prompt"]
                        send_buttons(gr, v, out3d)
                        tab_vars.append(v)
                    with gr.TabItem("Text-to-Image-to-3D"):
                        v = {}
                        seed = seed_box(gr)
                        imw = _schema_block(gr, P.image_defaults,
                                            _IMAGE_BASIC, advanced)
                        img_out = gr.Image(label="Image")
                        gr.Button("Generate image").click(
                            fns["text_to_img"],
                            [seed] + _ordered_inputs(
                                imw, P.image_defaults, _IMAGE_BASIC,
                                advanced),
                            [img_out], api_name="text_to_img")
                        v["output_image"] = img_out
            with gr.TabItem("Image-to-3D"):
                with gr.Tabs():
                    for version, seg_api in (("1.1", "image_segmentation"),
                                             ("1.2", False)):
                        vt = version.replace(".", "_")
                        with gr.TabItem(f"Zero123++ v{version}/MVEdit"):
                            v = {}
                            seed = seed_box(gr)
                            in_img = gr.Image(label="Input image")
                            seg_out = gr.Image(label="Segmented")
                            gr.Button("Segment").click(
                                fns["image_segmentation"], [in_img],
                                [seg_out],
                                api_name=seg_api)
                            grid_out = gr.Image(label="6 views")
                            nmw = _schema_block(
                                gr, P.nerf_mesh_defaults,
                                _NERF_MESH_BASIC, advanced)
                            srw = superres_block(gr)
                            views = [gr.Image(label=f"View {i}",
                                              visible=debug)
                                     for i in range(6)]
                            normals = ([gr.Image(label=f"Normal {i}",
                                                 visible=debug)
                                        for i in range(6)]
                                       if version == "1.2" else [])
                            v["in_image"] = in_img
                            gr.Button("Generate views").click(
                                fns[f"img_to_3d_{vt}_zero123plus"],
                                [seed, in_img],
                                [grid_out],
                                api_name=f"img_to_3d_{vt}_zero123plus")
                            out3d = gr.Model3D(label="Output mesh")
                            gr.Button("Generate 3D").click(
                                fns[f"img_to_3d_{vt}_zero123plus_to_mesh"],
                                [seed, in_img] + _ordered_inputs(
                                    nmw, P.nerf_mesh_defaults,
                                    _NERF_MESH_BASIC, advanced)
                                + sr_inputs(srw) + views + normals,
                                [out3d],
                                api_name=f"img_to_3d_{vt}_"
                                         "zero123plus_to_mesh")
                            send_buttons(gr, v, out3d)
                            tab_vars.append(v)
            with gr.TabItem("3D-to-3D"):
                with gr.Tabs():
                    for instruct, api in ((False, "3d_to_3d_mvedit"),
                                          (True,
                                           "3d_to_3d_mvedit_instruct")):
                        name = "MVEdit Instruct" if instruct else "MVEdit"
                        with gr.TabItem(name):
                            v = {}
                            seed = seed_box(gr)
                            in_mesh = gr.Model3D(label="Input mesh")
                            proc = gr.Textbox(label="Preproc state",
                                              visible=bool(debug))
                            fvid = gr.Number(value=0, precision=0,
                                             label="Front view ID")
                            gr.Button("Preprocess").click(
                                fns["3d_preproc"], [in_mesh],
                                [in_mesh, proc, fvid],
                                api_name="3d_preproc" if not instruct
                                else False)
                            ov = (P.instruct_3d_to_3d_params if instruct
                                  else P.text_3d_to_3d_params)
                            nmw = _schema_block(
                                gr, P.nerf_mesh_defaults,
                                _NERF_MESH_BASIC, advanced, overrides=ov,
                                instruct=instruct)
                            srw = superres_block(gr)
                            v["in_mesh"] = in_mesh
                            v["instruct"] = instruct
                            out3d = gr.Model3D(label="Output mesh")
                            gr.Button("Run MVEdit").click(
                                fns[api],
                                [seed, in_mesh, fvid] + _ordered_inputs(
                                    nmw, P.nerf_mesh_defaults,
                                    _NERF_MESH_BASIC, advanced)
                                + sr_inputs(srw),
                                [out3d], api_name=api)
                            send_buttons(gr, v, out3d)
                            tab_vars.append(v)
            with gr.TabItem("Re-Texturing"):
                with gr.Tabs():
                    for instruct, api in ((False, "retex_mvedit"),
                                          (True, "retex_mvedit_instruct")):
                        name = "MVEdit Instruct" if instruct else "MVEdit"
                        with gr.TabItem(name):
                            v = {}
                            seed = seed_box(gr)
                            in_mesh = gr.Model3D(label="Input mesh")
                            fvid = gr.Number(value=0, precision=0,
                                             label="Front view ID")
                            ov = (P.instruct_retex_params if instruct
                                  else None)
                            rtw = _schema_block(
                                gr, P.retex_defaults, _RETEX_BASIC,
                                advanced, overrides=ov, instruct=instruct)
                            srw = superres_block(gr)
                            extra = []
                            if not instruct:
                                gin = gr.Image(label="Image guidance")
                                extra = [gin]
                            v["in_mesh"] = in_mesh
                            v["instruct"] = instruct
                            v["is_retex"] = True
                            out3d = gr.Model3D(label="Output mesh")
                            gr.Button("Re-texture").click(
                                fns[api],
                                [seed, in_mesh, fvid] + _ordered_inputs(
                                    rtw, P.retex_defaults, _RETEX_BASIC,
                                    advanced)
                                + sr_inputs(srw) + extra,
                                [out3d], api_name=api)
                            send_buttons(gr, v, out3d)
                            tab_vars.append(v)
            with gr.TabItem("Tools"):
                with gr.TabItem("Export video (mesh)"):
                    vid_mesh = gr.Model3D(label="Mesh")
                    send_targets["video_mesh"] = vid_mesh
                    fvid = gr.Number(value=0, precision=0,
                                     label="Front view ID")
                    opts = [_make_widget(gr, k, d) for k, d in
                            (("distance", 4.0), ("elevation", 10.0),
                             ("fov", 30), ("length", 10),
                             ("resolution", 512), ("lossless", False),
                             ("layer", "RGB"))]
                    out_vid = gr.Video(label="Orbit video")
                    gr.Button("Export").click(
                        fns["mesh_to_video"], [vid_mesh, fvid] + opts,
                        [out_vid],
                        api_name="mesh_to_video")

        # -------- cross-tab send-to wiring (app.py:188-267) --------------
        mesh_tabs = [v for v in tab_vars if "in_mesh" in v]

        def find_tab(instruct, retex):
            for t in mesh_tabs:
                if bool(t.get("instruct")) == instruct \
                        and bool(t.get("is_retex")) == retex:
                    return t
            return None

        routes = {"to_text_3d_to_3d": (False, False),
                  "to_instruct_3d_to_3d": (True, False),
                  "to_text_retex": (False, True),
                  "to_instruct_retex": (True, True)}
        for v in tab_vars:
            out = v.get("output")
            if out is None:
                continue
            for key, (instr, retex) in routes.items():
                tgt = find_tab(instr, retex)
                if key in v and tgt is not None:
                    v[key].click(lambda m: m, [out], [tgt["in_mesh"]],
                                 api_name=False)
            if "export_video_mesh" in v:
                v["export_video_mesh"].click(
                    lambda m: m, [out], [send_targets["video_mesh"]],
                    api_name=False)
    return app
