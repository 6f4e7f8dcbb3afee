"""JSON API server over HTTP (stdlib only; counterpart of
`mvedit_tpu/apis/server.py`).

The reference's Gradio named endpoints (text_to_3d_stablessdnerf*,
image_segmentation, img_to_3d_1_{1,2}_zero123plus*, 3d_preproc,
3d_to_3d_mvedit*, retex_mvedit*, texture_superres, mesh_to_video, and
text_to_img) as `POST /api/<endpoint>` with a JSON body; images, meshes
and videos travel as base64 fields. The routes, the bodies' keys and
defaults and the answers are the JAX server's.

The runner holds generators, model caches and kernel launch counters, so
the server runs one request at a time: each handler runs under one lock.
A handler that raises answers 500 with `{"error": message}` (its
traceback goes to stderr); an unknown route answers 404.
"""
import base64
import io
import json
import sys
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

__all__ = ["ApiServer"]


class ApiServer:
    def __init__(self, runner, host="127.0.0.1", port=7860):
        self.runner = runner
        self.host = host
        self.port = port
        self._httpd = None
        self._lock = threading.Lock()
        self.endpoints = {
            "image_segmentation": self._image_segmentation,
            "3d_preproc": self._mesh_preproc,
            "text_to_img": self._text_to_img,
            "text_to_3d_stablessdnerf": self._stablessdnerf,
            "text_to_3d_stablessdnerf_to_mesh": self._stablessdnerf_to_mesh,
            "img_to_3d_1_1_zero123plus": self._zero123plus("1.1"),
            "img_to_3d_1_2_zero123plus": self._zero123plus("1.2"),
            "img_to_3d_1_1_zero123plus_to_mesh":
                self._zero123plus_to_mesh("1.1"),
            "img_to_3d_1_2_zero123plus_to_mesh":
                self._zero123plus_to_mesh("1.2"),
            "3d_to_3d_mvedit": self._3d_to_3d(False),
            "3d_to_3d_mvedit_instruct": self._3d_to_3d(True),
            "retex_mvedit": self._retex(False),
            "retex_mvedit_instruct": self._retex(True),
            "texture_superres": self._texture_superres,
            "mesh_to_video": self._mesh_to_video,
            "health": lambda body: {"status": "ok"},
        }

    # --- payloads -------------------------------------------------------

    @staticmethod
    def _decode_image(b64):
        from PIL import Image
        img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
        return np.asarray(img, np.float32) / 255.0

    @staticmethod
    def _encode_image(arr):
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)
                        ).save(buf, format="png")
        return base64.b64encode(buf.getvalue()).decode()

    @staticmethod
    def _mesh_in(body, fin):
        fin.write(base64.b64decode(body["mesh"]))
        fin.flush()
        return fin.name

    @staticmethod
    def _file_b64(path):
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    # --- endpoints ------------------------------------------------------

    def _image_segmentation(self, body):
        img = self._decode_image(body["image"])
        mask = self.runner.run_segmentation(img[None])[0]
        if isinstance(mask, torch.Tensor):
            mask = mask.float().cpu().numpy()
        return {"mask": self._encode_image(np.asarray(mask).repeat(3, -1))}

    def _mesh_preproc(self, body):
        with tempfile.NamedTemporaryFile(suffix=".glb") as fin:
            out = self.runner.run_mesh_preproc(self._mesh_in(body, fin))
        return {"center": np.asarray(out["center"]).tolist(),
                "scale": float(out["scale"]),
                "num_verts": int(len(out["mesh"].v)),
                "num_faces": int(len(out["mesh"].f))}

    def _retex(self, instruct):
        def fn(body):
            with tempfile.NamedTemporaryFile(suffix=".glb") as fin, \
                    tempfile.NamedTemporaryFile(suffix=".glb") as fout:
                self.runner.run_retex(
                    self._mesh_in(body, fin), body.get("prompt", ""),
                    body.get("negative_prompt", ""),
                    seed=body.get("seed", 42),
                    steps=body.get("steps", 12), instruct=instruct,
                    front_view_id=body.get("front_view_id"),
                    out_path=fout.name)
                return {"mesh": self._file_b64(fout.name)}
        return fn

    def _text_to_img(self, body):
        img = self.runner.run_text_to_img(
            body.get("prompt", ""), body.get("negative_prompt", ""),
            seed=body.get("seed", 42), steps=body.get("steps", 24),
            cfg_scale=body.get("cfg_scale", 7.0),
            width=body.get("width"), height=body.get("height"))
        return {"image": self._encode_image(img)}

    def _stablessdnerf(self, body):
        out = self.runner.run_stablessdnerf(
            body.get("prompt", ""), seed=body.get("seed", 42),
            cfg_scale=body.get("cfg_scale", 7.0))
        return {"preview": self._encode_image(out["preview"])}

    def _stablessdnerf_to_mesh(self, body):
        with tempfile.NamedTemporaryFile(suffix=".glb") as fout:
            self.runner.run_stablessdnerf_to_mesh(
                body.get("prompt", ""), seed=body.get("seed", 42),
                out_path=fout.name)
            return {"mesh": self._file_b64(fout.name)}

    def _zero123plus(self, version):
        def fn(body):
            grid = self.runner.run_zero123plus(
                self._decode_image(body["image"]),
                seed=body.get("seed", 42), version=version)
            return {"views": self._encode_image(np.asarray(grid))}
        return fn

    def _zero123plus_to_mesh(self, version):
        def fn(body):
            with tempfile.NamedTemporaryFile(suffix=".glb") as fout:
                self.runner.run_zero123plus_to_mesh(
                    self._decode_image(body["image"]),
                    seed=body.get("seed", 42), version=version,
                    prompt=body.get("prompt", ""),
                    negative_prompt=body.get("negative_prompt", ""),
                    out_path=fout.name)
                return {"mesh": self._file_b64(fout.name)}
        return fn

    def _3d_to_3d(self, instruct):
        def fn(body):
            with tempfile.NamedTemporaryFile(suffix=".glb") as fin, \
                    tempfile.NamedTemporaryFile(suffix=".glb") as fout:
                self.runner.run_3d_to_3d(
                    self._mesh_in(body, fin), body.get("prompt", ""),
                    body.get("negative_prompt", ""),
                    seed=body.get("seed", 42),
                    steps=body.get("steps"), instruct=instruct,
                    out_path=fout.name)
                return {"mesh": self._file_b64(fout.name)}
        return fn

    def _texture_superres(self, body):
        with tempfile.NamedTemporaryFile(suffix=".glb") as fin, \
                tempfile.NamedTemporaryFile(suffix=".glb") as fout:
            self.runner.run_texture_superres(
                self._mesh_in(body, fin), body.get("prompt", ""),
                body.get("negative_prompt", ""),
                seed=body.get("seed", 42), out_path=fout.name)
            return {"mesh": self._file_b64(fout.name)}

    def _mesh_to_video(self, body):
        with tempfile.NamedTemporaryFile(suffix=".glb") as fin, \
                tempfile.NamedTemporaryFile(suffix=".mp4") as fout:
            path = self.runner.run_mesh_to_video(
                self._mesh_in(body, fin), out_path=fout.name,
                num_frames=body.get("num_frames", 30))
            return {"video": self._file_b64(path),
                    "format": path.rsplit(".", 1)[-1]}

    # --- server ---------------------------------------------------------

    def handle(self, name, body):
        """(status, answer) of one request to the route `name`: 404 and
        None for an unknown route, 500 and {"error"} when its handler
        raises, else 200 and its answer. One request at a time."""
        fn = self.endpoints.get(name)
        if fn is None:
            return 404, None
        with self._lock:
            try:
                return 200, fn(body)
            except Exception as e:  # the server keeps answering
                traceback.print_exc(file=sys.stderr)
                return 500, {"error": str(e)}

    def serve(self, background=False):
        """Serve on (host, port) (port 0: any free port, read back from
        `server_address`); with `background`, from a daemon thread, which
        is returned."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                name = self.path.strip("/").split("/")[-1]
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                try:
                    body = json.loads(raw or b"{}")
                except ValueError as e:
                    status, out = 500, {"error": f"bad JSON body: {e}"}
                else:
                    status, out = server.handle(name, body)
                self.send_response(status)
                if out is None:
                    self.end_headers()
                    return
                data = json.dumps(out).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        if background:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True)
            t.start()
            return t
        self._httpd.serve_forever()

    @property
    def server_address(self):
        """(host, port) the server listens on, once `serve` has bound."""
        return self._httpd.server_address

    def shutdown(self):
        """Stop serving and close the socket."""
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
