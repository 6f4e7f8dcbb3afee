"""Mesh container + OBJ / GLB I/O, numpy on the host (a copy of
`mvedit_tpu/models/mesh/container.py`, whose package `__init__` imports JAX).

The reference `Mesh` container and its hand-rolled writers: vertices /
faces, optional normals, UVs (with separate ft indices), albedo texture or
vertex colours, AABB normalisation, the yz-flip GLB convention, plus:

- OBJ read / write;
- GLB (glTF 2.0 binary) read / write with an embedded PNG texture, laid
  out by hand (no trimesh / pygltflib);
- `auto_normal`: area-weighted smooth normals;
- `auto_uv`: xatlas when importable, else a per-triangle grid atlas.
"""
import io
import json
import struct
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

__all__ = ["Mesh"]


@dataclass
class Mesh:
    v: np.ndarray                      # (V, 3) float32
    f: np.ndarray                      # (F, 3) int32
    vn: Optional[np.ndarray] = None    # (Vn, 3)
    fn: Optional[np.ndarray] = None    # (F, 3) into vn
    vt: Optional[np.ndarray] = None    # (Vt, 2) uv
    ft: Optional[np.ndarray] = None    # (F, 3) into vt
    albedo: Optional[np.ndarray] = None  # (H, W, 3) float [0,1]
    vc: Optional[np.ndarray] = None    # (V, 3) vertex colors
    textureless: bool = False

    # --- geometry utilities -------------------------------------------------

    def aabb(self):
        return self.v.min(0), self.v.max(0)

    def auto_size(self, target_radius=0.9):
        """Center + scale into a sphere of `target_radius`
        (mesh_utils.py:694 normalize)."""
        vmin, vmax = self.aabb()
        center = (vmin + vmax) / 2
        scale = target_radius / max(
            np.linalg.norm(self.v - center, axis=-1).max(), 1e-8)
        self.v = ((self.v - center) * scale).astype(np.float32)
        return center, scale

    def auto_normal(self):
        """Area-weighted per-vertex normals."""
        i0, i1, i2 = self.f[:, 0], self.f[:, 1], self.f[:, 2]
        v0, v1, v2 = self.v[i0], self.v[i1], self.v[i2]
        fn = np.cross(v1 - v0, v2 - v0)
        vn = np.zeros_like(self.v)
        np.add.at(vn, i0, fn)
        np.add.at(vn, i1, fn)
        np.add.at(vn, i2, fn)
        vn /= np.clip(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12, None)
        self.vn = vn.astype(np.float32)
        self.fn = self.f.copy()
        return self

    def auto_uv(self, atlas_tris_per_row=None):
        """Assign UVs. Prefers xatlas when available; else a per-triangle
        grid atlas: each face gets its own right triangle in a regular grid
        (robust, seam-free with edge dilation; storage-inefficient)."""
        try:
            import xatlas  # noqa
            vmapping, indices, uvs = xatlas.parametrize(
                self.v.astype(np.float32), self.f.astype(np.uint32))
            self.vt = uvs.astype(np.float32)
            self.ft = indices.astype(np.int32)
            return self
        except ImportError:
            pass
        F = len(self.f)
        if F == 0:
            self.vt = np.zeros((0, 2), np.float32)
            self.ft = np.zeros((0, 3), np.int32)
            return self
        n = atlas_tris_per_row or int(np.ceil(np.sqrt(F)))
        rows = int(np.ceil(F / n))
        pad = 0.15  # fraction of a cell kept as margin
        cell_w, cell_h = 1.0 / n, 1.0 / rows
        fi = np.arange(F)
        cx = (fi % n) * cell_w
        cy = (fi // n) * cell_h
        m = pad * min(cell_w, cell_h)
        p0 = np.stack([cx + m, cy + m], -1)
        p1 = np.stack([cx + cell_w - m, cy + m], -1)
        p2 = np.stack([cx + m, cy + cell_h - m], -1)
        self.vt = np.concatenate([p0, p1, p2], axis=0).astype(np.float32)
        self.ft = np.stack([fi, fi + F, fi + 2 * F], -1).astype(np.int32)
        return self

    def face_areas(self):
        v0, v1, v2 = (self.v[self.f[:, i]] for i in range(3))
        return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)

    # --- IO -----------------------------------------------------------------

    @classmethod
    def load(cls, path):
        path = str(path)
        if path.endswith(".obj"):
            return cls.load_obj(path)
        if path.endswith((".glb", ".gltf")):
            return cls.load_glb(path)
        raise ValueError(f"unsupported mesh format: {path}")

    def write(self, path, flip_yz=False):
        path = str(path)
        mesh = self
        if flip_yz:
            # GLB convention: y-up; our world is z-up (mesh_utils.py:461)
            v = mesh.v[:, [0, 2, 1]].copy()
            v[:, 2] *= -1
            vn = None
            if mesh.vn is not None:
                vn = mesh.vn[:, [0, 2, 1]].copy()
                vn[:, 2] *= -1
            mesh = replace(mesh, v=v, vn=vn)
        if path.endswith(".obj"):
            mesh.write_obj(path)
        elif path.endswith(".glb"):
            mesh.write_glb(path)
        elif path.endswith(".ply"):
            mesh.write_ply(path)
        else:
            raise ValueError(f"unsupported mesh format: {path}")

    @classmethod
    def load_obj(cls, path):
        v, vt, vn, f, ft, fn = [], [], [], [], [], []
        with open(path) as fh:
            for line in fh:
                t = line.split()
                if not t:
                    continue
                if t[0] == "v":
                    v.append([float(x) for x in t[1:4]])
                elif t[0] == "vt":
                    vt.append([float(t[1]), float(t[2])])
                elif t[0] == "vn":
                    vn.append([float(x) for x in t[1:4]])
                elif t[0] == "f":
                    idx = [p.split("/") for p in t[1:]]
                    # triangulate fan
                    for k in range(1, len(idx) - 1):
                        tri = [idx[0], idx[k], idx[k + 1]]
                        f.append([int(p[0]) - 1 for p in tri])
                        if len(tri[0]) > 1 and tri[0][1]:
                            ft.append([int(p[1]) - 1 for p in tri])
                        if len(tri[0]) > 2 and tri[0][2]:
                            fn.append([int(p[2]) - 1 for p in tri])
        return cls(
            v=np.array(v, np.float32), f=np.array(f, np.int32),
            vt=np.array(vt, np.float32) if vt else None,
            ft=np.array(ft, np.int32) if ft else None,
            vn=np.array(vn, np.float32) if vn else None,
            fn=np.array(fn, np.int32) if fn else None,
            textureless=not vt)

    def write_obj(self, path):
        with open(path, "w") as fh:
            mtl = None
            if self.albedo is not None:
                mtl = str(path)[:-4]
                fh.write(f"mtllib {mtl.split('/')[-1]}.mtl\n")
            for p in self.v:
                fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            if self.vt is not None:
                for t in self.vt:
                    fh.write(f"vt {t[0]:.6f} {1 - t[1]:.6f}\n")
            if self.vn is not None:
                for nrm in self.vn:
                    fh.write(f"vn {nrm[0]:.6f} {nrm[1]:.6f} {nrm[2]:.6f}\n")
            for i, face in enumerate(self.f):
                parts = []
                for j in range(3):
                    s = str(face[j] + 1)
                    if self.ft is not None:
                        s += f"/{self.ft[i, j] + 1}"
                    if self.fn is not None:
                        s += ("" if self.ft is not None else "/") \
                            + f"/{self.fn[i, j] + 1}"
                    parts.append(s)
                fh.write("f " + " ".join(parts) + "\n")
        if self.albedo is not None:
            from PIL import Image
            Image.fromarray(
                (np.clip(np.nan_to_num(self.albedo), 0, 1) * 255
                 ).astype(np.uint8)).save(mtl + ".png")
            with open(mtl + ".mtl", "w") as fh:
                fh.write("newmtl default\nKd 1 1 1\n"
                         f"map_Kd {mtl.split('/')[-1]}.png\n")

    def write_ply(self, path):
        with open(path, "wb") as fh:
            head = ["ply", "format binary_little_endian 1.0",
                    f"element vertex {len(self.v)}",
                    "property float x", "property float y",
                    "property float z"]
            if self.vc is not None:
                head += ["property uchar red", "property uchar green",
                         "property uchar blue"]
            head += [f"element face {len(self.f)}",
                     "property list uchar int vertex_indices", "end_header"]
            fh.write(("\n".join(head) + "\n").encode())
            if self.vc is not None:
                vc = (np.clip(self.vc, 0, 1) * 255).astype(np.uint8)
                for p, c in zip(self.v, vc):
                    fh.write(struct.pack("<fff3B", *p, *c))
            else:
                fh.write(self.v.astype("<f4").tobytes())
            cnt = np.full((len(self.f), 1), 3, np.uint8)
            body = b"".join(
                struct.pack("<B3i", 3, *face) for face in self.f)
            fh.write(body)
            del cnt

    # --- GLB ---------------------------------------------------------------

    def write_glb(self, path):
        """Minimal but valid glTF 2.0 binary with one textured mesh."""
        # indexed geometry must share one index buffer -> unweld if separate
        # uv topology
        m = self
        if m.ft is not None and (m.vt is None or len(m.vt) != len(m.v)
                                 or not np.array_equal(m.f, m.ft)):
            v = m.v[m.f.reshape(-1)]
            vt = m.vt[m.ft.reshape(-1)] if m.vt is not None else None
            vn = m.vn[(m.fn if m.fn is not None else m.f).reshape(-1)] \
                if m.vn is not None else None
            f = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
            m = Mesh(v=v.astype(np.float32), f=f, vt=vt, vn=vn,
                     albedo=m.albedo, vc=None)

        buffers = []

        def add(arr):
            offset = sum(len(b) for b in buffers)
            data = np.ascontiguousarray(arr).tobytes()
            pad = (-len(data)) % 4
            buffers.append(data + b"\x00" * pad)
            return offset, len(data)

        idx_off, idx_len = add(m.f.astype(np.uint32))
        pos_off, pos_len = add(m.v.astype(np.float32))
        views = [
            {"buffer": 0, "byteOffset": idx_off, "byteLength": idx_len,
             "target": 34963},
            {"buffer": 0, "byteOffset": pos_off, "byteLength": pos_len,
             "target": 34962},
        ]
        accessors = [
            {"bufferView": 0, "componentType": 5125,
             "count": int(m.f.size), "type": "SCALAR"},
            {"bufferView": 1, "componentType": 5126, "count": len(m.v),
             "type": "VEC3", "min": m.v.min(0).tolist(),
             "max": m.v.max(0).tolist()},
        ]
        attributes = {"POSITION": 1}
        prim = {"attributes": attributes, "indices": 0, "material": 0}
        material = {"pbrMetallicRoughness": {
            "metallicFactor": 0.0, "roughnessFactor": 1.0},
            "doubleSided": False}
        images, textures, samplers = [], [], []
        if m.vn is not None:
            off, ln = add(m.vn.astype(np.float32))
            views.append({"buffer": 0, "byteOffset": off, "byteLength": ln,
                          "target": 34962})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": 5126, "count": len(m.vn),
                              "type": "VEC3"})
            attributes["NORMAL"] = len(accessors) - 1
        if m.vt is not None and m.albedo is not None:
            off, ln = add(m.vt.astype(np.float32))
            views.append({"buffer": 0, "byteOffset": off, "byteLength": ln,
                          "target": 34962})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": 5126, "count": len(m.vt),
                              "type": "VEC2"})
            attributes["TEXCOORD_0"] = len(accessors) - 1
            from PIL import Image
            bio = io.BytesIO()
            tex8 = (np.clip(np.nan_to_num(m.albedo), 0, 1)
                    * 255).astype(np.uint8)
            Image.fromarray(tex8).save(bio, format="png")
            off, ln = add(np.frombuffer(bio.getvalue(), np.uint8))
            views.append({"buffer": 0, "byteOffset": off, "byteLength": ln})
            images.append({"bufferView": len(views) - 1,
                           "mimeType": "image/png"})
            samplers.append({"magFilter": 9729, "minFilter": 9987,
                             "wrapS": 10497, "wrapT": 10497})
            textures.append({"sampler": 0, "source": 0})
            material["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": 0}
        elif m.vc is not None:
            vc4 = np.concatenate(
                [np.clip(m.vc, 0, 1),
                 np.ones((len(m.vc), 1), np.float32)], -1)
            off, ln = add(vc4.astype(np.float32))
            views.append({"buffer": 0, "byteOffset": off, "byteLength": ln,
                          "target": 34962})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": 5126, "count": len(m.vc),
                              "type": "VEC4"})
            attributes["COLOR_0"] = len(accessors) - 1

        bin_chunk = b"".join(buffers)
        gltf = {
            "asset": {"version": "2.0", "generator": "mvedit_tpu_torch"},
            "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [prim]}],
            "materials": [material],
            "buffers": [{"byteLength": len(bin_chunk)}],
            "bufferViews": views, "accessors": accessors,
        }
        if images:
            gltf.update(images=images, textures=textures, samplers=samplers)
        js = json.dumps(gltf).encode()
        js += b" " * ((-len(js)) % 4)
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        with open(path, "wb") as fh:
            fh.write(struct.pack("<III", 0x46546C67, 2, total))
            fh.write(struct.pack("<II", len(js), 0x4E4F534A))
            fh.write(js)
            fh.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
            fh.write(bin_chunk)

    @classmethod
    def load_glb(cls, path):
        """Load a GLB flattened into one Mesh (first texture wins). For
        multi-material scenes use `load_glb_parts` + atlas.merge_meshes
        (run_mesh_preproc does; ref preprocess_mesh mesh_utils.py:969)."""
        parts = cls.load_glb_parts(path)
        if len(parts) == 1:
            return parts[0]
        vs = np.concatenate([p.v for p in parts])
        voff = np.cumsum([0] + [len(p.v) for p in parts[:-1]])
        f = np.concatenate([p.f + o for p, o in zip(parts, voff)])
        all_vt = all(p.vt is not None and len(p.vt) == len(p.v)
                     for p in parts)
        all_vn = all(p.vn is not None for p in parts)
        all_vc = all(p.vc is not None for p in parts)
        vt = np.concatenate([p.vt for p in parts]) if all_vt else None
        vn = np.concatenate([p.vn for p in parts]) if all_vn else None
        vc = np.concatenate([p.vc for p in parts]) if all_vc else None
        albedo = next((p.albedo for p in parts if p.albedo is not None),
                      None)
        return cls(v=vs, f=f, vt=vt,
                   ft=f.copy() if vt is not None else None,
                   vn=vn, fn=f.copy() if vn is not None else None,
                   albedo=albedo, vc=vc, textureless=vt is None)

    @classmethod
    def load_glb_parts(cls, path):
        """Parse a GLB into per-primitive Meshes, each with its own
        material texture / base color (multi-material scene support,
        ref mesh_utils.py:969-1029 preprocess_mesh + imagepacker)."""
        with open(path, "rb") as fh:
            magic, ver, _ = struct.unpack("<III", fh.read(12))
            assert magic == 0x46546C67, "not a GLB file"
            chunks = {}
            while True:
                head = fh.read(8)
                if len(head) < 8:
                    break
                ln, typ = struct.unpack("<II", head)
                chunks[typ] = fh.read(ln)
        gltf = json.loads(chunks[0x4E4F534A])
        bin_chunk = chunks.get(0x004E4942, b"")

        def read_accessor(ai):
            acc = gltf["accessors"][ai]
            view = gltf["bufferViews"][acc["bufferView"]]
            off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            ncomp = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}[acc["type"]]
            dt = {5126: np.float32, 5125: np.uint32, 5123: np.uint16,
                  5121: np.uint8}[acc["componentType"]]
            count = acc["count"]
            arr = np.frombuffer(bin_chunk, dt, count * ncomp, off)
            arr = arr.reshape(count, ncomp) if ncomp > 1 else arr
            if acc["componentType"] in (5123, 5121) \
                    and acc["type"] != "SCALAR":
                # normalized integer attributes (e.g. COLOR_0 u8/u16)
                arr = arr.astype(np.float32) / np.float32(
                    {5123: 65535, 5121: 255}[acc["componentType"]])
            return arr

        def read_image(ii):
            from PIL import Image
            img = gltf["images"][ii]
            if "bufferView" not in img:
                return None
            view = gltf["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = bin_chunk[off:off + view["byteLength"]]
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                              np.float32) / 255.0

        def material_albedo(mi):
            if mi is None or "materials" not in gltf:
                return None
            mat = gltf["materials"][mi]
            pbr = mat.get("pbrMetallicRoughness", {})
            tex = pbr.get("baseColorTexture")
            if tex is not None and "textures" in gltf:
                src = gltf["textures"][tex["index"]].get("source")
                if src is not None:
                    return read_image(src)
            fac = pbr.get("baseColorFactor")
            if fac is not None:
                return np.broadcast_to(
                    np.asarray(fac[:3], np.float32), (16, 16, 3)).copy()
            return None

        parts = []
        for mesh in gltf.get("meshes", []):
            for prim in mesh["primitives"]:
                att = prim["attributes"]
                v = read_accessor(att["POSITION"]).astype(np.float32)
                f = read_accessor(prim["indices"]).astype(
                    np.int32).reshape(-1, 3)
                vt = read_accessor(att["TEXCOORD_0"]).astype(np.float32) \
                    if "TEXCOORD_0" in att else None
                vn = read_accessor(att["NORMAL"]).astype(np.float32) \
                    if "NORMAL" in att else None
                vc = None
                if "COLOR_0" in att:
                    vc = np.asarray(read_accessor(att["COLOR_0"]),
                                    np.float32)[:, :3]
                albedo = material_albedo(prim.get("material"))
                parts.append(cls(
                    v=v, f=f, vt=vt,
                    ft=f.copy() if vt is not None else None,
                    vn=vn, fn=f.copy() if vn is not None else None,
                    albedo=albedo, vc=vc, textureless=vt is None))
        if not parts:
            raise ValueError(f"no mesh primitives in {path}")
        return parts
