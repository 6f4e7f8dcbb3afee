"""The port covers the JAX package: every public top-level function and
class of `mvedit_tpu/**/*.py`, and every public method of those classes,
is named in the port's sources (`mvedit_tpu_torch/**/*.py`, `.cu`, `.cpp`),
or stands in `LEFT_OUT`, the names the port deliberately does not keep,
each with its reason. A second case keeps `LEFT_OUT` from going stale:
each of its names still exists in the JAX package.

The test reads source files with `ast`; it imports neither package.
"""
import ast
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FLAX_CONVERTER = ("a torch -> flax weight converter: the port reads torch "
                   "state dicts as they are")
_PYTREE = "a JAX pytree hook: the port's containers are plain objects"
_FLAX_SETUP = ("a flax `setup`: the port's modules build their layers in "
               "`__init__`")

# qualified name (`name` or `Class.method`) -> why the port leaves it out
LEFT_OUT = {
    "jax_sigmoid": "a jnp sigmoid, 1 / (1 + exp(-x)); the port calls "
                   "`torch.sigmoid`",
    "SparseVolume.tree_flatten": _PYTREE,
    "SparseVolume.tree_unflatten": _PYTREE,
    "NeighborData.tree_flatten": _PYTREE,
    "NeighborData.tree_unflatten": _PYTREE,
    "convert_unet": _FLAX_CONVERTER,
    "convert_controlnet": _FLAX_CONVERTER,
    "convert_vae": _FLAX_CONVERTER,
    "convert_clip_text": _FLAX_CONVERTER,
    "convert_srvgg": _FLAX_CONVERTER,
    "convert_dpt": _FLAX_CONVERTER,
    "convert_loftr": _FLAX_CONVERTER,
    "convert_sam": _FLAX_CONVERTER,
    "convert_tracer": _FLAX_CONVERTER,
    "unflatten": "builds the flax params tree of a converter's flat keys",
    "merge_params": "merges a converter's flax params into a seeded tree",
    "NerfTargets": "a static-shape pytree of the NeRF fit's targets for "
                   "XLA; the port passes tensors",
    "clear_renderer_cache": "evicts compiled TPU programs from device "
                            "memory; the port compiles none",
    "RasterConfig.resolved_backend": "picks the Pallas or the XLA "
                                     "selection; the port always runs "
                                     "`kernels.raster_select`",
    "AutoencoderKL.setup": _FLAX_SETUP,
    "PromptEncoder.setup": _FLAX_SETUP,
    "SamModel.setup": _FLAX_SETUP,
    "VAEResnet": "ported as the function `models/diffusion/vae.py::"
                 "_resnet`",
}


def _public(body):
    return [n for n in body if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        and not n.name.startswith("_")]


def _jax_names():
    """{qualified name: file} of the JAX package's public top-level
    functions and classes and their public methods."""
    out = {}
    for root, _, files in os.walk(os.path.join(REPO, "mvedit_tpu")):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            rel = os.path.relpath(path, REPO)
            for node in _public(tree.body):
                out[node.name] = rel
                if isinstance(node, ast.ClassDef):
                    for m in _public(node.body):
                        out[f"{node.name}.{m.name}"] = rel
    return out


def _port_words():
    words = set()
    for root, dirs, files in os.walk(os.path.join(REPO, "mvedit_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                with open(os.path.join(root, f)) as fh:
                    words.update(re.findall(r"[A-Za-z_]\w*", fh.read()))
    return words


def test_every_public_name_of_the_jax_package_is_in_the_port():
    words = _port_words()
    missing = sorted(f"{path}::{q}" for q, path in _jax_names().items()
                     if q.split(".")[-1] not in words and q not in LEFT_OUT)
    assert not missing, f"not in the port and not in LEFT_OUT: {missing}"


def test_left_out_names_exist_in_the_jax_package():
    jax = _jax_names()
    stale = sorted(q for q in LEFT_OUT if q not in jax)
    assert not stale, f"LEFT_OUT names gone from the JAX package: {stale}"
    assert all(LEFT_OUT.values())
