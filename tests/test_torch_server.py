"""The port's JSON API server against the JAX package's, on the CPU.

- every route of `mvedit_tpu/apis/server.py` through both servers'
  handlers with a recording fake runner: the same runner method, the same
  arguments (mesh files compared by their bytes) and the same answers;
  the port's fake returns its masks as a tensor, as the port's runner
  does;
- a real tiny port runner served over 127.0.0.1 (port 0): `health`,
  `text_to_img` (2 steps, 64^2), `text_to_3d_stablessdnerf` (4 steps, the
  32^2 preview), their PNGs decoded, the preview equal to the endpoint's
  own; one request at a time;
- a 404 for an unknown route, a 500 with `error` for a raising handler
  and for a body that is not JSON, and the server still answering after
  them.
"""
import base64
import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from mvedit_tpu.apis.server import ApiServer as JServer

from mvedit_tpu_torch.apis import Adapter3DRunner, ApiServer

torch.set_num_threads(4)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray((arr * 255).astype(np.uint8)).save(buf, format="png")
    return base64.b64encode(buf.getvalue()).decode()


def _unpng(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))),
                      np.float32) / 255.0


class FakeMesh:
    v = np.zeros((5, 3), np.float32)
    f = np.zeros((7, 3), np.int32)


class RecordingRunner:
    """Records each call (name, args, kwargs), a path argument as the
    bytes of its file; writes `out_path` and returns canned outputs."""

    def __init__(self, tensor_masks=False, fail=False):
        self.calls, self.tensor_masks, self.fail = [], tensor_masks, fail
        rng = np.random.default_rng(0)
        self.image = rng.random((8, 6, 3)).astype(np.float32)
        self.mask = (rng.random((1, 8, 6, 1)) > 0.5).astype(np.float32)

    def _rec(self, name, args, kwargs):
        if self.fail:
            raise RuntimeError(f"{name} failed")

        def norm(x):
            if isinstance(x, str) and os.path.exists(x):
                with open(x, "rb") as f:
                    return ("file", f.read())
            if isinstance(x, np.ndarray):
                return ("array", x.shape, x.tobytes())
            return x
        self.calls.append((name, tuple(norm(a) for a in args),
                           {k: norm(v) for k, v in kwargs.items()
                            if k != "out_path"}))
        out = kwargs.get("out_path")
        if out:
            with open(out, "wb") as f:
                f.write(f"<{name}>".encode())
        return out

    def run_segmentation(self, *a, **k):
        self._rec("run_segmentation", a, k)
        return torch.from_numpy(self.mask) if self.tensor_masks \
            else self.mask

    def run_mesh_preproc(self, *a, **k):
        self._rec("run_mesh_preproc", a, k)
        return {"center": np.array([0.1, 0.2, 0.3]), "scale": 1.5,
                "mesh": FakeMesh()}

    def run_text_to_img(self, *a, **k):
        self._rec("run_text_to_img", a, k)
        return self.image

    def run_stablessdnerf(self, *a, **k):
        self._rec("run_stablessdnerf", a, k)
        return {"preview": self.image}

    def run_zero123plus(self, *a, **k):
        self._rec("run_zero123plus", a, k)
        return self.image

    def run_mesh_to_video(self, *a, **k):
        return self._rec("run_mesh_to_video", a, k)

    def __getattr__(self, name):       # the GLB-writing endpoints
        if not name.startswith("run_"):
            raise AttributeError(name)
        return lambda *a, **k: self._rec(name, a, k)


BODIES = {
    "image_segmentation": {"image": None},
    "3d_preproc": {"mesh": None},
    "text_to_img": {"prompt": "a cat", "seed": 3, "steps": 2, "width": 64},
    "text_to_3d_stablessdnerf": {"prompt": "a car", "seed": 5},
    "text_to_3d_stablessdnerf_to_mesh": {"prompt": "a car"},
    "img_to_3d_1_1_zero123plus": {"image": None, "seed": 2},
    "img_to_3d_1_2_zero123plus": {"image": None},
    "img_to_3d_1_1_zero123plus_to_mesh": {"image": None, "prompt": "x"},
    "img_to_3d_1_2_zero123plus_to_mesh": {"image": None, "seed": 9},
    "3d_to_3d_mvedit": {"mesh": None, "prompt": "a", "steps": 3},
    "3d_to_3d_mvedit_instruct": {"mesh": None, "negative_prompt": "b"},
    "retex_mvedit": {"mesh": None, "prompt": "c", "front_view_id": 1},
    "retex_mvedit_instruct": {"mesh": None, "seed": 4},
    "texture_superres": {"mesh": None, "prompt": "d"},
    "mesh_to_video": {"mesh": None, "num_frames": 3},
    "health": {},
}


def _body(name):
    body = dict(BODIES[name])
    if "image" in body:
        body["image"] = _png(np.random.default_rng(1).random((8, 6, 3)))
    if "mesh" in body:
        body["mesh"] = base64.b64encode(b"glTF-bytes").decode()
    return body


def test_routes_are_the_jax_servers():
    assert sorted(ApiServer(None).endpoints) == \
        sorted(JServer(None).endpoints) == sorted(BODIES)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_route_calls_and_answers_match_jax(name):
    jr, tr = RecordingRunner(), RecordingRunner(tensor_masks=True)
    body = _body(name)
    out_j = JServer(jr).endpoints[name](dict(body))
    status, out_t = ApiServer(tr).handle(name, dict(body))
    assert status == 200
    assert tr.calls == jr.calls and (name == "health" or len(tr.calls) == 1)
    assert out_t == out_j


@pytest.fixture(scope="module")
def served():
    runner = Adapter3DRunner(tiny_models=True, seed=0, device="cpu")
    server = ApiServer(runner, port=0)
    thread = server.serve(background=True)
    host, port = server.server_address
    assert host == "127.0.0.1" and port > 0
    yield runner, f"http://{host}:{port}/api/"
    server.shutdown()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_real_runner_over_http(served):
    runner, url = served
    status, data = _post(url + "health", b"")
    assert status == 200 and json.loads(data) == {"status": "ok"}
    status, data = _post(url + "text_to_img", json.dumps(
        {"prompt": "a red car", "seed": 3, "steps": 2}).encode())
    assert status == 200, data[-500:]
    img = _unpng(json.loads(data)["image"])
    assert img.shape == (64, 64, 3)
    status, data = _post(url + "text_to_3d_stablessdnerf", json.dumps(
        {"prompt": "a red car", "seed": 5}).encode())
    assert status == 200, data[-500:]
    prev = _unpng(json.loads(data)["preview"])
    own = runner.run_stablessdnerf("a red car", seed=5)["preview"]
    assert prev.shape == own.shape == (32, 32, 3)
    np.testing.assert_array_equal(
        prev, (np.clip(own, 0, 1) * 255).astype(np.uint8) / np.float32(255))


def test_errors_over_http(served):
    runner, url = served
    status, data = _post(url + "no_such_route", b"{}")
    assert status == 404 and data == b""
    status, data = _post(url + "3d_preproc", b"{}")      # no "mesh"
    assert status == 500 and "mesh" in json.loads(data)["error"]
    status, data = _post(url + "health", b"{not json")
    assert status == 500 and "JSON" in json.loads(data)["error"]
    status, data = _post(url + "health", b"{}")
    assert status == 200


def test_raising_handler_answers_500():
    status, out = ApiServer(RecordingRunner(fail=True)).handle(
        "text_to_img", {"prompt": "x"})
    assert status == 500 and out == {"error": "run_text_to_img failed"}
    assert ApiServer(None).handle("nope", {}) == (404, None)
