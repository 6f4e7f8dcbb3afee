"""GLB -> OBJ converter (counterpart of `tools/glb_to_obj.py`), through the
port's `models/mesh/container.py::Mesh`.

  python -m mvedit_tpu_torch.tools.glb_to_obj in.glb [out.obj]
"""
import argparse

__all__ = ["main"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst", nargs="?")
    return ap.parse_args(argv)


def main(argv=None):
    from ..models.mesh import Mesh
    args = parse_args(argv)
    dst = args.dst or args.src.rsplit(".", 1)[0] + ".obj"
    mesh = Mesh.load(args.src)
    mesh.write(dst)
    print(f"wrote {dst}: {len(mesh.v)} verts, {len(mesh.f)} faces")
    return dst


if __name__ == "__main__":
    main()
