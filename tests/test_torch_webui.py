"""The web UI (`apis/webui.py`), port against the JAX package on the CPU.

`endpoint_signature` equals JAX's for every endpoint at both `advanced`
values. Both packages' `build_app` run on a stand-in gradio
(`tests/torch_gradio.py`) with a runner that records its calls: the same
clicks in the same order (api names, the positional input widgets, the
outputs, the send-to wiring), and for every named endpoint the same runner
calls with the same arguments from the same positional values, and the
same results (the per-call output paths, which hold a fresh uuid, compared
by suffix), at `advanced` False and True. Pinned: JAX's retex adapters
pass `denoising_strength` and `cfg_scale` twice and raise `TypeError`;
the port's pass each once, the call JAX's own helpers compose. The
port's video adapter returns the file the runner wrote (a GIF without
ffmpeg), JAX's the .mp4 path it asked for. The port's adapters are the
module-level `endpoint_adapters`; the module imports without gradio and
`build_app` raises `ImportError` without it.
"""
import json
import re
import sys

import numpy as np
import pytest
import torch

from mvedit_tpu.apis import parameters as JP
from mvedit_tpu.apis import webui as JW

from mvedit_tpu_torch.apis import parameters as TP
from mvedit_tpu_torch.apis import webui as TW

from torch_gradio import make_gradio


class RecordingRunner:
    """Records each endpoint call; answers with seeded values, as tensors
    where the port's runner returns tensors (`tensors`)."""

    def __init__(self, tensors):
        self.calls, self.tensors = [], tensors
        self.rng = np.random.default_rng(0)

    def _rec(self, name, *args, **kwargs):
        self.calls.append((name, args, kwargs))

    def _arr(self, *shape):
        a = self.rng.random(shape).astype(np.float32)
        return torch.from_numpy(a) if self.tensors else a

    def run_segmentation(self, images, *a, **k):
        self._rec("run_segmentation", images, *a, **k)
        return self._arr(1, *np.shape(images)[1:3], 1)

    def run_mesh_preproc(self, *a, **k):
        self._rec("run_mesh_preproc", *a, **k)
        return {"center": np.array([0.1, 0.2, 0.3], np.float32),
                "scale": np.float32(1.25)}

    def run_zero123plus(self, *a, **k):
        self._rec("run_zero123plus", *a, **k)
        return self.rng.random((48, 32, 3)).astype(np.float32)

    def run_stablessdnerf(self, *a, **k):
        self._rec("run_stablessdnerf", *a, **k)
        return {"preview": self._arr(32, 32, 3),
                "code": self._arr(3, 4, 8, 8)}

    def run_text_to_img(self, *a, **k):
        self._rec("run_text_to_img", *a, **k)
        return self.rng.random((64, 64, 3)).astype(np.float32)

    def _plain(name):
        def f(self, *a, **k):
            self._rec(name, *a, **k)
        return f
    run_zero123plus_to_mesh = _plain("run_zero123plus_to_mesh")
    run_3d_to_3d = _plain("run_3d_to_3d")
    run_retex = _plain("run_retex")
    run_stablessdnerf_to_mesh = _plain("run_stablessdnerf_to_mesh")
    run_mesh_to_video = _plain("run_mesh_to_video")


def _values(advanced):
    """A positional value for every input name of every endpoint, some
    away from the schema defaults."""
    rng = np.random.default_rng(1)
    vals = {}
    for d in (JP.nerf_mesh_defaults, JP.retex_defaults, JP.image_defaults):
        vals.update(d)
    vals.update({"seed": 7, "prompt": "a red car", "negative_prompt": "blur",
                 "steps": 3, "cfg_scale": 5.5, "denoising_strength": 0.6,
                 "scheduler": "DDIM", "width": 64, "height": 48,
                 "image": (rng.random((24, 20, 4)) * 255).astype(np.uint8),
                 "in_image": (rng.random((16, 16, 3)) * 255).astype(
                     np.uint8),
                 "mesh": "in.glb", "front_view_id": 2, "triplane": "t.npy",
                 "distance": 3.5, "elevation": 20.0, "fov": 35,
                 "length": 2, "resolution": 64, "lossless": False,
                 "layer": "RGB"})
    for k, v in JP.superres_defaults.items():
        vals["superres_" + k] = v
    vals["superres_do_superres"] = advanced
    vals["superres_steps"] = 4
    for i in range(6):
        vals[f"view_{i}"] = vals[f"normal_{i}"] = None
    return vals


_UUID = re.compile(r"output_[0-9a-f-]{36}")


def _norm(x):
    """Comparable form: arrays by dtype, shape and bytes; the per-call
    output paths by their suffix."""
    if torch.is_tensor(x):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in sorted(x.items())}
    if isinstance(x, str) and _UUID.search(x):
        try:
            return ("json", _norm(json.loads(x)))
        except ValueError:
            return ("out", _UUID.sub("output_X", x).rsplit("/", 1)[-1])
    return x


def _app(monkeypatch, module, advanced):
    gr = make_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    runner = RecordingRunner(tensors=module is TW)
    module.build_app(runner, advanced=advanced)
    return gr.clicks, runner


def test_signatures_equal_jax():
    for advanced in (False, True):
        for name in JW.ENDPOINT_NAMES:
            assert TW.endpoint_signature(name, advanced) == \
                JW.endpoint_signature(name, advanced)
    assert TW.ENDPOINT_NAMES == JW.ENDPOINT_NAMES
    assert TW.SCHEDULERS == JW.SCHEDULERS
    for d in ("nerf_mesh_defaults", "retex_defaults", "superres_defaults",
              "image_defaults"):
        assert list(getattr(TP, d).items()) == list(getattr(JP, d).items())


@pytest.mark.parametrize("advanced", [False, True])
def test_build_app_wiring_equals_jax(monkeypatch, advanced):
    tclicks, _ = _app(monkeypatch, TW, advanced)
    jclicks, _ = _app(monkeypatch, JW, advanced)
    assert len(tclicks) == len(jclicks) > 14

    def layout(clicks):
        return [(c.api_name, c.button.describe(),
                 [w.describe() for w in c.inputs],
                 [w.describe() for w in c.outputs]) for c in clicks]
    assert layout(tclicks) == layout(jclicks)
    named = [c.api_name for c in tclicks if c.api_name]
    assert sorted(named) == sorted(JW.ENDPOINT_NAMES)
    # the app wires the module-level adapters
    adapters = TW.endpoint_adapters(RecordingRunner(True), advanced)
    assert sorted(adapters) == sorted(named)
    for c in tclicks:
        if c.api_name:
            assert c.fn.__qualname__ == adapters[c.api_name].__qualname__
            assert len(c.inputs) == len(TW.endpoint_signature(
                c.api_name, advanced))


@pytest.mark.parametrize("advanced", [False, True])
def test_adapters_make_jax_calls(monkeypatch, advanced):
    tclicks, trun = _app(monkeypatch, TW, advanced)
    jclicks, jrun = _app(monkeypatch, JW, advanced)
    vals = _values(advanced)
    tfn = {c.api_name: c.fn for c in tclicks if c.api_name}
    jfn = {c.api_name: c.fn for c in jclicks if c.api_name}
    for name in JW.ENDPOINT_NAMES:
        names = JW.endpoint_signature(name, advanced)
        args = [vals[k] for k in names]
        trun.calls.clear()
        jrun.calls.clear()
        tout = tfn[name](*args)
        assert len(trun.calls) == 1, name
        if name.startswith("retex_mvedit"):
            # pinned: the JAX adapter passes denoising_strength and
            # cfg_scale twice, so its call raises before the runner; the
            # port's is the call the JAX helpers compose, each key once
            with pytest.raises(TypeError, match="multiple values"):
                jfn[name](*args)
            kw, sr = JW._split_args(names, args)
            want = JW._schema_kwargs(kw, JP.retex_defaults)
            want.update(
                negative_prompt=kw["negative_prompt"], seed=7, steps=3,
                denoising_strength=0.6, cfg_scale=5.5,
                instruct=name.endswith("instruct"),
                out_path=trun.calls[0][2]["out_path"], front_view_id=2,
                in_image=None if name.endswith("instruct")
                else JW._img01(vals["in_image"])[..., :3],
                superres=JW._superres_arg(sr))
            jrun.calls.append(("run_retex", ("in.glb", "a red car"), want))
        else:
            jout = jfn[name](*args)
            assert _norm(tout) == _norm(jout), name
        assert _norm(trun.calls) == _norm(jrun.calls), name


class GifRunner(RecordingRunner):
    """Writes its videos as a GIF beside the .mp4 asked for, as the
    runners do without ffmpeg."""

    def run_mesh_to_video(self, mesh, out_path, **k):
        self._rec("run_mesh_to_video", mesh, out_path=out_path, **k)
        return out_path[:-4] + ".gif"


def test_video_adapter_returns_the_written_file(monkeypatch):
    """Pinned: the port's adapter returns the file the runner wrote; the
    JAX package's returns the .mp4 path it asked for."""
    args = [_values(False)[k] for k in TW.endpoint_signature(
        "mesh_to_video")]
    out = {}
    for module in (TW, JW):
        gr = make_gradio()
        monkeypatch.setitem(sys.modules, "gradio", gr)
        module.build_app(GifRunner(module is TW))
        fn = next(c.fn for c in gr.clicks if c.api_name == "mesh_to_video")
        out[module] = fn(*args)
    assert out[TW].endswith(".gif") and out[JW].endswith(".mp4")


def test_imports_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="ApiServer"):
        TW.build_app(RecordingRunner(True))
    assert "endpoint_adapters" in TW.__all__
