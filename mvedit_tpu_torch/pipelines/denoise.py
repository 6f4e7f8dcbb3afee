"""Multi-view denoise steps (1-pass and 2-pass, reference pairs, view
chunking).

Counterpart of `mvedit_tpu/pipelines/denoise.py`. The functions have the
reference's signatures without the parameter arguments: the modules in
`DenoiseModels` carry their weights. Latents, hints and noise predictions
are NHWC; the CFG batch is [uncond; cond] along the first axis.

- 1-pass: all ControlNets -> UNet, CFG combine.
- 2-pass: p1 runs the UNet encoder once and the decoder with the depth and
  extra ControlNets (the x0 estimate for the 3D fuse); p2 re-runs only the
  decoder with tile (+ depth) residuals added to p1's.
- use_reference: the uncond half runs per view, the cond half as
  [reference, target] pairs that self-attend jointly (k=2).
- ip_context (2N, T, C), [uncond; cond] like the CFG batch: IP-Adapter
  image tokens for the UNet's cross-attentions (a reference pair's two
  rows share their view's tokens); the ControlNets never see them.
"""
from dataclasses import dataclass
from typing import Tuple

import torch

from ..models.diffusion import AttnMode
from ..models.diffusion.controlnet import apply_multi_controlnet

__all__ = ["DenoiseModels", "make_noise_pred_1pass", "make_noise_pred_2pass",
           "make_chunked_noise_pred_1pass", "make_chunked_noise_pred_2pass",
           "chunk_view_batches"]


@dataclass(frozen=True)
class DenoiseModels:
    """UNet + ControlNets (tile, depth[, extra...]) and attention options;
    see the reference's DenoiseModels for `use_reference`."""
    unet: object
    controlnets: Tuple[object, ...]
    num_views: int = 6
    ip_tokens: int = 0
    ip_scale: float = 1.0
    use_reference: bool = False

    def attn_mode(self, num_views=None):
        return AttnMode(num_views=num_views or self.num_views,
                        ip_tokens=self.ip_tokens, ip_scale=self.ip_scale)


def _cfg_combine(noise_pred, guidance_scale):
    uncond, cond = noise_pred.chunk(2, dim=0)
    return guidance_scale * cond + (1.0 - guidance_scale) * uncond


def _pair(ref, tgt):
    """Interleave [ref_i, tgt_i] pairs: (N, ...) x2 -> (2N, ...)."""
    return torch.stack([ref, tgt], dim=1).reshape(2 * tgt.shape[0],
                                                  *tgt.shape[1:])


def _unpair_target(x):
    """(2N, ...) interleaved pairs -> the target halves (N, ...)."""
    return x.reshape(x.shape[0] // 2, 2, *x.shape[1:])[:, 1]


def _split_ip(ip_context, N):
    """The (2N, T, C) [uncond; cond] image tokens -> (per-view uncond rows,
    cond rows repeated for each [reference, target] pair)."""
    if ip_context is None:
        return None, None
    return ip_context[:N], ip_context[N:].repeat_interleave(2, 0)


def _pad_pair_residuals(downs, mid):
    """Zero residuals for the reference half of each pair."""
    def pad(r):
        return torch.stack([torch.zeros_like(r), r], dim=1).reshape(
            2 * r.shape[0], *r.shape[1:])
    if downs is None:
        return None, None
    return [pad(r) for r in downs], pad(mid)


def make_noise_pred_1pass(models: DenoiseModels):
    """(latents, t, embeds, cond_images, cn_scales, gs, ip_context,
    ref_noisy) -> guided noise pred (N, h, w, 4)."""
    unet = models.unet

    @torch.inference_mode()
    def noise_pred(latents, t, embeds, cond_images, cn_scales,
                   guidance_scale, ip_context=None, ref_noisy=None):
        n = len(models.controlnets)
        downs, mid = apply_multi_controlnet(
            models.controlnets, latents, t, embeds, list(cond_images)[:n],
            list(cn_scales)[:n])
        if models.use_reference and ref_noisy is not None:
            N = latents.shape[0] // 2
            ip_u, ip_c = _split_ip(ip_context, N)
            eps_u = unet(latents[:N], t[:N], embeds[:N],
                         mode=models.attn_mode(1), ip_context=ip_u,
                         down_block_res=[r[:N] for r in downs],
                         mid_block_res=mid[:N])
            pd, pm = _pad_pair_residuals([r[N:] for r in downs], mid[N:])
            eps_pairs = unet(_pair(ref_noisy, latents[N:]),
                             t[N:].repeat_interleave(2, 0),
                             embeds[N:].repeat_interleave(2, 0),
                             mode=models.attn_mode(2), ip_context=ip_c,
                             down_block_res=pd, mid_block_res=pm)
            eps_c = _unpair_target(eps_pairs)
            return guidance_scale * eps_c + (1 - guidance_scale) * eps_u
        eps = unet(latents, t, embeds, mode=models.attn_mode(),
                   ip_context=ip_context, down_block_res=downs,
                   mid_block_res=mid)
        return _cfg_combine(eps, guidance_scale)

    return noise_pred


def make_noise_pred_2pass(models: DenoiseModels):
    """Returns (p1, p2).

    p1(latents, t, embeds, depth_images, depth_scale, gs, ip_context,
       extra_images, extra_scales, ref_noisy)
       -> (eps_guided, enc_state, p1_residuals)
    p2(latents, enc_state, p1_residuals, t, embeds, tile_images,
       depth_images, tile_scale, depth_scale, gs, ip_context, ref_noisy)
       -> eps_guided
    """
    unet = models.unet

    def _ref_split_run(latents, t, embeds, downs, mid, ref_noisy,
                       guidance_scale, ip_context, enc_state=None):
        """Uncond per view + cond as [ref, target] pairs, CFG-combined.
        Returns (eps, (enc_u, enc_c))."""
        N = latents.shape[0] // 2
        amode_u, amode_c = models.attn_mode(1), models.attn_mode(2)
        ip_u, ip_c = _split_ip(ip_context, N)
        pair_lat = _pair(ref_noisy, latents[N:])
        t_u, e_u = t[:N], embeds[:N]
        t_c = t[N:].repeat_interleave(2, 0)
        e_c = embeds[N:].repeat_interleave(2, 0)
        downs_u = None if downs is None else [r[:N] for r in downs]
        mid_u = None if mid is None else mid[:N]
        if downs is None:
            downs_c = mid_c = None
        else:
            downs_c, mid_c = _pad_pair_residuals([r[N:] for r in downs],
                                                 mid[N:])
        if enc_state is None:
            enc_u = unet(latents[:N], t_u, e_u, part="enc", mode=amode_u,
                         ip_context=ip_u)
            enc_c = unet(pair_lat, t_c, e_c, part="enc", mode=amode_c,
                         ip_context=ip_c)
        else:
            enc_u, enc_c = enc_state
        eps_u = unet(None, None, None, part="dec", enc_state=enc_u,
                     mode=amode_u, ip_context=ip_u, down_block_res=downs_u,
                     mid_block_res=mid_u)
        eps_pairs = unet(None, None, None, part="dec", enc_state=enc_c,
                         mode=amode_c, ip_context=ip_c,
                         down_block_res=downs_c, mid_block_res=mid_c)
        eps_c = _unpair_target(eps_pairs)
        eps = guidance_scale * eps_c + (1 - guidance_scale) * eps_u
        return eps, (enc_u, enc_c)

    @torch.inference_mode()
    def p1(latents, t, embeds, depth_images, depth_scale, guidance_scale,
           ip_context=None, extra_images=(), extra_scales=(),
           ref_noisy=None):
        use_depth = depth_images is not None and len(models.controlnets) > 1
        nets, conds, scales = [], [], []
        if use_depth:
            nets.append(models.controlnets[1])
            conds.append(depth_images)
            scales.append(depth_scale)
        for j in range(max(len(models.controlnets) - 2, 0)):
            if j < len(extra_images):
                nets.append(models.controlnets[2 + j])
                conds.append(extra_images[j])
                scales.append(extra_scales[j] if j < len(extra_scales)
                              else 1.0)
        if nets:
            downs, mid = apply_multi_controlnet(nets, latents, t, embeds,
                                                conds, scales)
        else:
            downs, mid = None, None
        if models.use_reference and ref_noisy is not None:
            eps, enc = _ref_split_run(latents, t, embeds, downs, mid,
                                      ref_noisy, guidance_scale, ip_context)
            return eps, enc, (downs, mid)
        mode = models.attn_mode()
        enc = unet(latents, t, embeds, part="enc", mode=mode,
                   ip_context=ip_context)
        eps = unet(None, None, None, part="dec", enc_state=enc, mode=mode,
                   ip_context=ip_context, down_block_res=downs,
                   mid_block_res=mid)
        return _cfg_combine(eps, guidance_scale), enc, (downs, mid)

    @torch.inference_mode()
    def p2(latents, enc_state, p1_residuals, t, embeds, tile_images,
           depth_images, tile_scale, depth_scale, guidance_scale,
           ip_context=None, ref_noisy=None):
        if depth_images is not None:
            nets = models.controlnets[:2]
            conds, scales = [tile_images, depth_images], [tile_scale,
                                                          depth_scale]
        else:
            nets, conds, scales = models.controlnets[:1], [tile_images], \
                [tile_scale]
        downs, mid = apply_multi_controlnet(nets, latents, t, embeds, conds,
                                            scales)
        p1_downs, p1_mid = p1_residuals
        if p1_downs is not None:
            downs = [a + b for a, b in zip(downs, p1_downs)]
            mid = mid + p1_mid
        if models.use_reference and ref_noisy is not None:
            eps, _ = _ref_split_run(latents, t, embeds, downs, mid,
                                    ref_noisy, guidance_scale, ip_context,
                                    enc_state=enc_state)
            return eps
        eps = unet(None, None, None, part="dec", enc_state=enc_state,
                   mode=models.attn_mode(), ip_context=ip_context,
                   down_block_res=downs, mid_block_res=mid)
        return _cfg_combine(eps, guidance_scale)

    return p1, p2


# ---------------------------------------------------------------------------
# diff_bs view chunking. In use_reference mode the UNet has no cross-view
# attention (uncond per view, cond as [ref, target] pairs), so splitting
# the view axis into chunks of diff_bs is exact; it bounds peak memory.
# ---------------------------------------------------------------------------

def _pad_rows(x, n):
    return x if n == 0 else torch.cat(
        [x, x[-1:].expand(n, *x.shape[1:])], dim=0)


def _take_views(x, N, i, b):
    """Rows i:i+b of a per-view (N, ...) tensor, padded up to b."""
    sl = x[i:min(i + b, N)]
    return _pad_rows(sl, b - sl.shape[0])


def _take_cfg(x, N, i, b):
    """(2N, ...) CFG batch [uncond; cond] -> (2b, ...) chunk."""
    return torch.cat([_take_views(x[:N], N, i, b),
                      _take_views(x[N:], N, i, b)], dim=0)


def _take_pairs(x, N, i, b):
    """(2N, ...) pair-interleaved [r0, t0, r1, t1, ...] -> (2b, ...)."""
    y = x.reshape(N, 2, *x.shape[1:])
    return _take_views(y, N, i, b).reshape(2 * b, *x.shape[1:])


def _take_ip(ip_context, N, i, b):
    return None if ip_context is None else _take_cfg(ip_context, N, i, b)


def _cat_views(chunks, N):
    return torch.cat(chunks, dim=0)[:N]


def _cat_cfg(chunks, N, b):
    u = torch.cat([c[:b] for c in chunks], dim=0)[:N]
    c_ = torch.cat([c[b:] for c in chunks], dim=0)[:N]
    return torch.cat([u, c_], dim=0)


def _cat_pairs(chunks, N):
    out = torch.cat([c.reshape(-1, 2, *c.shape[1:]) for c in chunks],
                    dim=0)[:N]
    return out.reshape(2 * N, *out.shape[2:])


def _tree_map(fn, *trees):
    """Map over matching dict / list / tuple trees; None stays None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _tree_cat(fn_cat, chunk_trees):
    return _tree_map(lambda *xs: fn_cat(list(xs)), *chunk_trees)


def chunk_view_batches(fn, diff_bs):
    """Wrap fn(x) so x's leading (view) axis runs diff_bs rows per call;
    the remainder is padded up to one chunk."""
    b = int(diff_bs)

    def run(x):
        n = x.shape[0]
        if b <= 0 or n <= b:
            return fn(x)
        outs = [fn(x[i:i + b]) for i in range(0, (n // b) * b, b)]
        r = n % b
        if r:
            outs.append(fn(_pad_rows(x[n - r:], b - r))[:r])
        return torch.cat(outs, dim=0)
    return run


def make_chunked_noise_pred_1pass(models: DenoiseModels, diff_bs: int):
    """1-pass noise pred with the view axis processed diff_bs at a time
    (exact in use_reference mode; the whole batch otherwise)."""
    full = make_noise_pred_1pass(models)
    b = int(diff_bs)

    def noise_pred(latents, t, embeds, cond_images, cn_scales,
                   guidance_scale, ip_context=None, ref_noisy=None):
        N = latents.shape[0] // 2
        if ref_noisy is None or not models.use_reference or N <= b:
            return full(latents, t, embeds, cond_images, cn_scales,
                        guidance_scale, ip_context=ip_context,
                        ref_noisy=ref_noisy)
        outs = []
        for i in range(0, N, b):
            outs.append(full(
                _take_cfg(latents, N, i, b), _take_cfg(t, N, i, b),
                _take_cfg(embeds, N, i, b),
                [_take_cfg(ci, N, i, b) for ci in cond_images], cn_scales,
                guidance_scale, ip_context=_take_ip(ip_context, N, i, b),
                ref_noisy=_take_views(ref_noisy, N, i, b)))
        return _cat_views(outs, N)

    return noise_pred


def make_chunked_noise_pred_2pass(models: DenoiseModels, diff_bs: int):
    """(p1, p2) with the view axis processed diff_bs at a time. Outputs are
    reassembled into the whole-batch layouts, so either p1 feeds either p2.
    Exact in use_reference mode; the whole batch otherwise."""
    p1_full, p2_full = make_noise_pred_2pass(models)
    b = int(diff_bs)

    def p1(latents, t, embeds, depth_images, depth_scale, guidance_scale,
           ip_context=None, extra_images=(), extra_scales=(),
           ref_noisy=None):
        N = latents.shape[0] // 2
        if ref_noisy is None or not models.use_reference or N <= b:
            return p1_full(latents, t, embeds, depth_images, depth_scale,
                           guidance_scale, ip_context=ip_context,
                           extra_images=extra_images,
                           extra_scales=extra_scales, ref_noisy=ref_noisy)
        eps_ch, enc_u_ch, enc_c_ch, downs_ch, mid_ch = [], [], [], [], []
        for i in range(0, N, b):
            eps_i, (enc_u, enc_c), (downs, mid) = p1_full(
                _take_cfg(latents, N, i, b), _take_cfg(t, N, i, b),
                _take_cfg(embeds, N, i, b),
                None if depth_images is None
                else _take_cfg(depth_images, N, i, b),
                depth_scale, guidance_scale,
                ip_context=_take_ip(ip_context, N, i, b),
                extra_images=tuple(_take_cfg(e, N, i, b)
                                   for e in extra_images),
                extra_scales=extra_scales,
                ref_noisy=_take_views(ref_noisy, N, i, b))
            eps_ch.append(eps_i)
            enc_u_ch.append(enc_u)
            enc_c_ch.append(enc_c)
            downs_ch.append(downs)
            mid_ch.append(mid)
        eps = _cat_views(eps_ch, N)
        enc_state = (_tree_cat(lambda xs: _cat_views(xs, N), enc_u_ch),
                     _tree_cat(lambda xs: _cat_pairs(xs, N), enc_c_ch))
        p1_res = (_tree_cat(lambda xs: _cat_cfg(xs, N, b), downs_ch),
                  _tree_cat(lambda xs: _cat_cfg(xs, N, b), mid_ch))
        return eps, enc_state, p1_res

    def p2(latents, enc_state, p1_residuals, t, embeds, tile_images,
           depth_images, tile_scale, depth_scale, guidance_scale,
           ip_context=None, ref_noisy=None):
        N = latents.shape[0] // 2
        if ref_noisy is None or not models.use_reference or N <= b:
            return p2_full(latents, enc_state, p1_residuals, t, embeds,
                           tile_images, depth_images, tile_scale,
                           depth_scale, guidance_scale,
                           ip_context=ip_context, ref_noisy=ref_noisy)
        enc_u, enc_c = enc_state
        downs, mid = p1_residuals
        outs = []
        for i in range(0, N, b):
            enc_i = (_tree_map(lambda x: _take_views(x, N, i, b), enc_u),
                     _tree_map(lambda x: _take_pairs(x, N, i, b), enc_c))
            res_i = (_tree_map(lambda x: _take_cfg(x, N, i, b), downs),
                     _tree_map(lambda x: _take_cfg(x, N, i, b), mid))
            outs.append(p2_full(
                _take_cfg(latents, N, i, b), enc_i, res_i,
                _take_cfg(t, N, i, b), _take_cfg(embeds, N, i, b),
                _take_cfg(tile_images, N, i, b),
                None if depth_images is None
                else _take_cfg(depth_images, N, i, b),
                tile_scale, depth_scale, guidance_scale,
                ip_context=_take_ip(ip_context, N, i, b),
                ref_noisy=_take_views(ref_noisy, N, i, b)))
        return _cat_views(outs, N)

    return p1, p2
