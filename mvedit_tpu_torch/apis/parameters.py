"""Public API parameter schema (a copy of `mvedit_tpu/apis/parameters.py`).

These ordered default dicts are the positional-argument contract of every
endpoint (the reference's `lib/core/webui/parameters.py:4-161`, kept as a
data table so that scripts written against it keep working). `diff_bs` is
accepted and unused here: the pipeline's `MVEdit3DConfig.diff_bs` sets the
view chunk of the UNet and VAE passes.
"""
from collections import OrderedDict

__all__ = [
    "nerf_mesh_defaults", "superres_defaults", "image_defaults",
    "retex_defaults", "stablessdnerf_defaults", "mesh_optim_defaults",
    "text_3d_to_3d_params", "instruct_3d_to_3d_params",
    "instruct_retex_params", "stablessdnerf_to_mesh_params",
    "parse_args", "parse_3d_args", "parse_2d_args",
]

_AUX_PROMPT = "best quality, sharp focus, photorealistic, extremely detailed"
_AUX_NEG = ("worst quality, low quality, depth of field, blurry, out of "
            "focus, low-res, illustration, painting, drawing")

nerf_mesh_defaults = OrderedDict([
    ("prompt", None), ("negative_prompt", None), ("scheduler", None),
    ("steps", None), ("denoising_strength", None), ("random_init", None),
    ("cfg_scale", 7), ("ingp_resolution", 320),
    ("checkpoint", "stable-diffusion-v1-5/stable-diffusion-v1-5"),
    ("max_num_views", 32), ("min_num_views", 9),
    ("aux_prompt", _AUX_PROMPT), ("aux_negative_prompt", _AUX_NEG),
    ("diff_bs", None), ("patch_size", 128), ("patch_bs_nerf", 1),
    ("render_bs", 6), ("patch_bs", 8), ("alpha_soften", 0.02),
    ("normal_reg_weight", 4.0), ("start_entropy_weight", 0.0),
    ("end_entropy_weight", 4.0), ("entropy_d", 0.015),
    ("mesh_smoothness", 1.0), ("n_inverse_steps", None),
    ("init_inverse_steps", None), ("tet_init_inverse_steps", 120),
    ("start_lr", 0.01), ("end_lr", 0.005), ("tet_resolution", None),
    ("mvedit_mode", "2-pass")])

superres_defaults = OrderedDict([
    ("do_superres", None), ("use_ip_adapter", None), ("scheduler", None),
    ("steps", None), ("denoising_strength", None), ("random_init", None),
    ("cfg_scale", 7), ("ingp_resolution", 320),
    ("checkpoint", "stable-diffusion-v1-5/stable-diffusion-v1-5"),
    ("aux_prompt", _AUX_PROMPT), ("aux_negative_prompt", _AUX_NEG),
    ("patch_size", 512), ("patch_bs", 1), ("n_inverse_steps", None),
    ("lr", 0.01)])

image_defaults = OrderedDict([
    ("width", 512), ("height", 512), ("prompt", None),
    ("negative_prompt", None), ("scheduler", None), ("steps", None),
    ("cfg_scale", 7), ("checkpoint", "Lykon/dreamshaper-8"),
    ("aux_prompt", _AUX_PROMPT), ("aux_negative_prompt", _AUX_NEG)])

retex_defaults = OrderedDict([
    ("prompt", None), ("negative_prompt", None), ("scheduler", None),
    ("steps", None), ("denoising_strength", None), ("random_init", None),
    ("cfg_scale", 7), ("ingp_resolution", 320), ("force_auto_uv", False),
    ("checkpoint", "Lykon/dreamshaper-8"), ("max_num_views", 32),
    ("min_num_views", 9), ("aux_prompt", "best quality"),
    ("aux_negative_prompt", "worst quality, low quality"), ("diff_bs", None),
    ("patch_size", 512), ("render_bs", 6), ("patch_bs", 1),
    ("n_inverse_steps", None), ("lr", 0.01), ("mvedit_mode", "2-pass")])

stablessdnerf_defaults = OrderedDict([
    ("prompt", None), ("negative_prompt", None), ("scheduler", None),
    ("steps", None), ("cfg_scale", 7), ("render_bs", 4)])

mesh_optim_defaults = OrderedDict([
    ("n_inverse_steps", None), ("ingp_resolution", 320),
    ("max_num_views", 64), ("min_num_views", 8), ("patch_size", 128),
    ("patch_bs_nerf", 2), ("render_bs", 12), ("patch_bs", 16),
    ("alpha_soften", 0.01), ("normal_reg_weight", 4.0),
    ("depth_weight", 100.0), ("start_entropy_weight", 0.0),
    ("end_entropy_weight", 4.0), ("entropy_d", 0.015),
    ("mesh_smoothness", 1.0), ("start_lr", 0.015), ("end_lr", 0.01),
    ("tet_resolution", None)])

# per-task overrides (parameters.py:122-161)
text_3d_to_3d_params = dict(
    alpha_soften=0.01, normal_reg_weight=1.2, start_entropy_weight=0.0,
    end_entropy_weight=4.0, mesh_smoothness=0.5, start_lr=0.0075,
    mvedit_mode="1-pass")
text_3d_to_3d_superres_params = dict(checkpoint="Lykon/dreamshaper-8")
instruct_3d_to_3d_params = dict(
    cfg_scale=5.0, normal_reg_weight=2.0, start_entropy_weight=0.0,
    end_entropy_weight=4.0, mesh_smoothness=0.5, entropy_d=0.02,
    start_lr=0.0075, aux_prompt="", aux_negative_prompt="blur the texture",
    mvedit_mode="1-pass")
instruct_retex_params = dict(
    aux_prompt="", aux_negative_prompt="blur the texture")
stablessdnerf_to_mesh_params = dict(
    alpha_soften=0.01, normal_reg_weight=0.2, start_entropy_weight=0.0,
    end_entropy_weight=4.0, mesh_smoothness=0.5, start_lr=0.01)


def parse_args(defaults, args, extra_overrides=None):
    """Positional args (in `defaults` order) -> kwargs dict
    (parameters.py:164-208 parser semantics)."""
    out = dict(defaults)
    keys = list(defaults.keys())
    for k, v in zip(keys, args):
        out[k] = v
    if extra_overrides:
        out.update(extra_overrides)
    missing = [k for k, v in out.items() if v is None]
    return out, missing


def parse_3d_args(args, overrides=None):
    return parse_args(nerf_mesh_defaults, args, overrides)


def parse_2d_args(args, overrides=None):
    return parse_args(image_defaults, args, overrides)
