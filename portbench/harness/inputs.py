"""Inputs made from the seed: a torus-knot tube written to a GLB, and RGB
images. The knot is a copy of the generator the port's chip smoke used;
the GLB writer is the benchmark's own (positions and triangle indices)."""
import json
import os
import pickle
import struct

import numpy as np

__all__ = ["torus_knot", "write_glb", "make_input", "write_srn"]


def torus_knot(p=2, q=3, nu=1000, nv=125, radius=0.8, tube=0.09):
    """A (p, q) torus-knot tube: (nu nv) verts, 2 nu nv faces, inside the
    unit sphere. Returns (verts (V, 3) f32, faces (F, 3) int32)."""
    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)

    def curve(t):
        r = 2 + np.cos(q * t)
        return np.stack([r * np.cos(p * t), r * np.sin(p * t),
                         -np.sin(q * t)], -1) * (radius / 3)
    c, dt = curve(t), 1e-4
    tan = curve(t + dt) - curve(t - dt)
    acc = curve(t + dt) - 2 * c + curve(t - dt)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    nrm = acc - (acc * tan).sum(-1, keepdims=True) * tan
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    bnm = np.cross(tan, nrm)
    a = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    v = (c[:, None] + tube * (np.cos(a)[None, :, None] * nrm[:, None]
                              + np.sin(a)[None, :, None] * bnm[:, None]))
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    v00, v10 = i * nv + j, ((i + 1) % nu) * nv + j
    v11, v01 = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    f = np.concatenate([np.stack([v00, v10, v11], -1).reshape(-1, 3),
                        np.stack([v00, v11, v01], -1).reshape(-1, 3)])
    return v.reshape(-1, 3).astype(np.float32), f.astype(np.int32)


def write_glb(path, verts, faces):
    """One triangle mesh, positions and uint32 indices, as glTF 2.0
    binary."""
    pos = np.ascontiguousarray(verts, np.float32).tobytes()
    idx = np.ascontiguousarray(faces, np.uint32).tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1, "mode": 4}]}],
        "buffers": [{"byteLength": len(pos) + len(idx)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos),
             "target": 34962},
            {"buffer": 0, "byteOffset": len(pos), "byteLength": len(idx),
             "target": 34963}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts),
             "type": "VEC3", "min": verts.min(0).tolist(),
             "max": verts.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125, "count": faces.size,
             "type": "SCALAR"}]}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    binary = pos + idx
    binary += b"\0" * (-len(binary) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2,
                            12 + 8 + len(js) + 8 + len(binary)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(binary), 0x004E4942) + binary)


def make_input(spec, seed, path):
    """One request's input from its traffic entry: a GLB of a knot
    (`{"kind": "torus_knot", "p", "q", "nu", "nv"}` and optionally
    `"radius"`, `"tube"`; seeded by nothing), or
    an image (`{"kind": "image", "size"}`, uniform from `seed`)."""
    if spec["kind"] == "torus_knot":
        v, f = torus_knot(spec["p"], spec["q"], spec["nu"], spec["nv"],
                          spec.get("radius", 0.8), spec.get("tube", 0.09))
        write_glb(path, v, f)
        return path
    if spec["kind"] == "image":
        s = spec["size"]
        return np.random.default_rng(seed).random((s, s, 3)).astype(
            np.float32)
    raise ValueError(f"unknown input kind {spec['kind']!r}")


def _look_at_poses(azi, elev, dist):
    """c2w (n, 4, 4) on a z-up orbit looking at the origin, OpenCV camera
    axes (columns right, down, forward)."""
    pos = np.stack([np.cos(azi) * np.cos(elev), np.sin(azi) * np.cos(elev),
                    np.sin(elev)], -1) * dist
    f = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    s = np.cross(f, np.array([0.0, 0.0, 1.0]))
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    u = np.cross(s, f)
    poses = np.zeros((len(azi), 4, 4))
    poses[:, :3, :3] = np.stack([s, -u, f], -1)
    poses[:, :3, 3] = pos
    poses[:, 3, 3] = 1.0
    return poses


def write_srn(root, spec, seed):
    """A dataset in ShapeNet SRN's layout under `root`, from the seed:
    `scenes` scenes of `views` views of `size`^2 (rgb/*.png, pose/*.txt
    c2w, intrinsics.txt), cameras on a sphere of radius 1.3 as SRN cars'
    (azimuths uniform, elevations in [-0.2, 1.2] rad, focal `focal`), and
    smooth seeded colour fields for images; and a captions pickle
    {scene: caption} drawn from `vocabulary`. Returns the pickle's
    path."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    rng = np.random.default_rng(seed)
    n, v, size = spec["scenes"], spec["views"], spec["size"]
    pool = ThreadPoolExecutor(8)
    jobs = []
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    caps, words = {}, spec["vocabulary"]
    for s in range(n):
        name = f"scene_{s:04d}"
        d = os.path.join(root, name)
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "pose"))
        poses = _look_at_poses(rng.uniform(0, 2 * np.pi, v),
                               rng.uniform(-0.2, 1.2, v), 1.3)
        freq = rng.uniform(1, 4, (v, 3, 2))
        phase = rng.uniform(0, 2 * np.pi, (v, 3))
        img = 0.5 + 0.5 * np.sin(freq[..., 0, None, None] * xx
                                 + freq[..., 1, None, None] * yy
                                 + phase[..., None, None])
        img = (img.transpose(0, 2, 3, 1) * 255).round().astype(np.uint8)
        for i in range(v):
            jobs.append(pool.submit(
                Image.fromarray(img[i]).save,
                os.path.join(d, "rgb", f"{i:06d}.png"), compress_level=1))
            with open(os.path.join(d, "pose", f"{i:06d}.txt"), "w") as f:
                f.write(" ".join(repr(float(x)) for x in poses[i].ravel())
                        + "\n")
        with open(os.path.join(d, "intrinsics.txt"), "w") as f:
            f.write(f"{spec['focal']} {size / 2} {size / 2} 0.\n0. 0. 0."
                    f"\n1.\n{size} {size}\n")
        caps[name] = " ".join(rng.choice(words, 4))
    for j in jobs:
        j.result()
    pool.shutdown()
    path = os.path.join(root, "captions.pkl")
    with open(path, "wb") as f:
        pickle.dump(caps, f)
    return path
