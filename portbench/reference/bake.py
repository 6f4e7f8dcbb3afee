"""Plain reference of the bake: the field's albedo written into a UV atlas,
then the atlas's edge dilation.

- `uv_raster`: which atlas texels a UV triangle covers (texel centres,
  edges inclusive) and the texel's barycentric weights, by enumerating
  the texels of each triangle's bounding box in float64: no tiles, no
  candidate lists, no capacities; texels on an edge to the rounding of
  float32 edge functions are left to either answer;
- `field_rgb`: the dense-grid field's albedo at world points, written out
  (per level the 8 cell corners gathered from the table in its gather
  type and blended with smoothstep weights in float32; the ReLU MLP in
  float32; a saturated sigmoid), from the configuration's field sizes;
- `bake_numbers`: the program's atlas against the reference's: the
  texels whose coverage differs past the band (exact otherwise), and the
  albedo's relative L2 distance over the texels both cover;
- `dilation`: `n_iters` rounds in which every texel outside the mask
  takes the mask-weighted mean of its 3 x 3 neighbours (zero-padded) and
  joins the mask where a neighbour was inside, with explicit shifts in
  float64.

With `control`, the same work a precision lower takes the program's
place: UV positions and the MLP in bfloat16 and the table in float8 for
the bake, bfloat16 for the dilation.
"""
import sys

import torch

from .fits import lower

__all__ = ["uv_raster", "field_rgb", "bake_numbers", "dilation",
           "dilation_rel"]


@torch.no_grad()
def uv_raster(uvs, uv_faces, height, width, chunk=1 << 22):
    """(face id (H, W) int64, -1 where nothing covers, weights (H, W, 3)
    of the face's three corners, inner (H, W), outer (H, W)) of a UV
    layout. A texel two faces cover (a shared edge) takes the larger face
    id. `inner` marks texels that some face covers with each of its three
    edge functions (twice the area a texel centre spans with an edge, in
    texels^2) at least `band`, `outer` those some face covers with each
    above -`band`: a texel between the two lies on an edge to the
    rounding of float32 edge functions at these coordinates, where either
    answer is right. `band` = 4 x 2^-24 x max(H, W)^2, a few units in the
    last place of the products `x_b y_c - x_c y_b` that such a function
    subtracts (0.25 texels^2 at 1024^2)."""
    dev = uvs.device
    band = 4.0 * 2.0 ** -24 * max(height, width) ** 2
    scale = torch.tensor([width, height], dtype=torch.float64, device=dev)
    tri = (uvs.double() * scale)[uv_faces.long()]               # (F, 3, 2)
    # the box reaches 2 texels past the triangle, past its band
    lo, hi = tri.min(1).values - 2.0, tri.max(1).values + 2.0
    x0 = torch.ceil(lo[:, 0] - 0.5).clamp(0, width - 1).long()
    x1 = torch.floor(hi[:, 0] - 0.5).clamp(-1, width - 1).long()
    y0 = torch.ceil(lo[:, 1] - 0.5).clamp(0, height - 1).long()
    y1 = torch.floor(hi[:, 1] - 0.5).clamp(-1, height - 1).long()
    nx, ny = (x1 - x0 + 1).clamp(min=0), (y1 - y0 + 1).clamp(min=0)
    count = nx * ny
    face_id = torch.full((height * width,), -1, dtype=torch.long,
                         device=dev)
    inner = torch.zeros(height * width, dtype=torch.bool, device=dev)
    outer = torch.zeros_like(inner)
    # faces in chunks of about `chunk` texel pairs
    ends = torch.cumsum(count, 0)
    f_lo = 0
    while f_lo < tri.shape[0]:
        base = int(ends[f_lo - 1]) if f_lo else 0
        f_hi = int(torch.searchsorted(ends, base + chunk, right=True))
        f_hi = max(f_hi, f_lo + 1)
        cnt = count[f_lo:f_hi]
        f = torch.arange(f_lo, f_hi, device=dev).repeat_interleave(cnt)
        if f.numel():
            k = torch.arange(f.numel(), device=dev) - (
                torch.cumsum(cnt, 0) - cnt).repeat_interleave(cnt)
            x = x0[f] + k % nx[f]
            y = y0[f] + k // nx[f]
            w, d = _weights(tri[f], x, y)
            e = w * d.abs()[..., None]                  # edge functions
            texel = y * width + x
            inside = (w >= 0).all(-1)
            face_id.scatter_reduce_(0, texel[inside], f[inside], "amax")
            inner[texel[(e >= band).all(-1)]] = True
            outer[texel[(e > -band).all(-1) & (d.abs() > 0)]] = True
        f_lo = f_hi
    face_id = face_id.view(height, width)
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    w, _ = _weights(tri[face_id.clamp(min=0)], xs, ys)
    w = torch.where(face_id[..., None] >= 0, w, torch.zeros_like(w))
    return (face_id, w, inner.view(height, width),
            outer.view(height, width))


def _weights(t, x, y):
    """(barycentric weights (..., 3) of the texel centres (x + 0.5, y +
    0.5) in the triangles t (..., 3, 2), all -1 for a degenerate one;
    twice the triangles' signed areas)."""
    qx, qy = x.double() + 0.5, y.double() + 0.5
    p0, p1, p2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    d = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) \
        - (p2[..., 0] - p0[..., 0]) * (p1[..., 1] - p0[..., 1])
    ok = d.abs() > 1e-12
    dd = torch.where(ok, d, torch.ones_like(d))
    l1 = ((qx - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
          - (p2[..., 0] - p0[..., 0]) * (qy - p0[..., 1])) / dd
    l2 = ((p1[..., 0] - p0[..., 0]) * (qy - p0[..., 1])
          - (qx - p0[..., 0]) * (p1[..., 1] - p0[..., 1])) / dd
    w = torch.stack([1 - l1 - l2, l1, l2], -1)
    return (torch.where(ok[..., None], w, torch.full_like(w, -1.0)),
            torch.where(ok, d, torch.zeros_like(d)))


@torch.no_grad()
def field_rgb(params, xyz, fcfg, control=False):
    """Albedo (N, 3) float32 of the dense-grid field at world points xyz
    (N, 3). fcfg: `resolutions`, `n_features`, `gather_dtype`, `bound`,
    `sigmoid_saturation` (the configuration's `field`)."""
    x = ((xyz.float() + fcfg["bound"]) / (2.0 * fcfg["bound"])).clamp(0, 1)
    gdt = getattr(torch, fcfg["gather_dtype"])
    F = fcfg["n_features"]
    feats = []
    for i, res in enumerate(fcfg["resolutions"]):
        tab = params["table"][f"level_{i}"].to(gdt)
        if control:
            tab = lower(tab)
        tab = tab.reshape(-1, F)
        pos = x * res
        p0 = torch.floor(pos)
        t = pos - p0
        w = t * t * (3.0 - 2.0 * t)
        p0i, side = p0.long(), res + 1
        acc = torch.zeros((x.shape[0], F), dtype=torch.float32,
                          device=x.device)
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    idx = (((p0i[:, 0] + ox).clamp(max=res) * side
                            + (p0i[:, 1] + oy).clamp(max=res)) * side
                           + (p0i[:, 2] + oz).clamp(max=res))
                    wc = ((w[:, 0] if ox else 1 - w[:, 0])
                          * (w[:, 1] if oy else 1 - w[:, 1])
                          * (w[:, 2] if oz else 1 - w[:, 2]))
                    acc = acc + tab[idx].float() * wc[:, None]
        feats.append(acc)
    h = torch.cat(feats, -1)
    mdt = torch.bfloat16 if control else torch.float32
    layers = params["mlp"]
    for j, layer in enumerate(layers):
        h = (h.to(mdt) @ layer["w"].to(mdt) + layer["b"].to(mdt)).float()
        if j != len(layers) - 1:
            h = torch.relu(h)
    s = fcfg["sigmoid_saturation"]
    return torch.sigmoid(h[..., 1:]) * (1 + 2 * s) - s


@torch.no_grad()
def bake_numbers(verts, faces, uvs, uv_faces, height, width, params, fcfg,
                 rgb, mask, control=False, rows=1 << 18):
    """(texels whose coverage differs, the albedo's relative L2 distance
    over the texels both cover) of the program's atlas `rgb` (H, W, 3),
    `mask` (H, W) against the reference bake of the same mesh, UV layout
    and field parameters. A texel counts where the program leaves out
    one that lies inside a face past the float32 rounding band, or covers
    one that lies outside every face past it."""
    face_id, w, inner, outer = uv_raster(uvs, uv_faces, height, width)
    cover = face_id >= 0
    if control:
        face_c, w_c, _, _ = uv_raster(lower(uvs), uv_faces, height, width)
        mask = (face_c >= 0).float()
    both = cover & (mask > 0)
    f = faces.long()[face_id[both]]                               # (N, 3)
    wt = w[both]
    xyz = (verts.double()[f] * wt[..., None]).sum(1)
    ref = torch.cat([field_rgb(params, xyz[i:i + rows], fcfg)
                     for i in range(0, xyz.shape[0], rows)]) \
        if xyz.shape[0] else torch.zeros((0, 3), device=verts.device)
    if control:
        fc = faces.long()[face_c[both].clamp(min=0)]
        xyz_c = (verts.double()[fc] * w_c[both][..., None]).sum(1)
        got = torch.cat([field_rgb(params, xyz_c[i:i + rows], fcfg, True)
                         for i in range(0, xyz_c.shape[0], rows)]) \
            if xyz_c.shape[0] else ref
    else:
        got = rgb[both].float()
    got_cover = mask > 0
    left_out, added = inner & ~got_cover, got_cover & ~outer
    coverage = float((left_out | added).sum())
    if not control:
        load = tile_load(uvs, uv_faces, height, width)
        sys.stderr.write(
            f"portbench: bake of {faces.shape[0]} faces at {width}x{height},"
            f" the fullest 16^2 tile touched by {load} faces' boxes; "
            f"texels left out {int(left_out.sum())}, added "
            f"{int(added.sum())}\n")
    rel = float(torch.linalg.vector_norm((got - ref).double())
                / torch.linalg.vector_norm(ref.double()).clamp_min(1e-30))
    return coverage, rel


@torch.no_grad()
def tile_load(uvs, uv_faces, height, width, tile=16):
    """The most UV triangles whose bounding boxes touch one tile (a
    diagnostic of a tiled raster's candidate lists)."""
    scale = torch.tensor([width, height], dtype=torch.float64,
                         device=uvs.device)
    tri = (uvs.double() * scale)[uv_faces.long()]
    lo = (tri.min(1).values // tile).long()
    hi = (tri.max(1).values // tile).long()
    tx, ty = (width + tile - 1) // tile, (height + tile - 1) // tile
    lo[:, 0].clamp_(0, tx - 1), lo[:, 1].clamp_(0, ty - 1)
    hi[:, 0].clamp_(0, tx - 1), hi[:, 1].clamp_(0, ty - 1)
    load = torch.zeros((ty, tx), dtype=torch.long, device=uvs.device)
    span = hi - lo + 1
    n = span[:, 0] * span[:, 1]
    f = torch.arange(tri.shape[0], device=uvs.device).repeat_interleave(n)
    k = torch.arange(f.numel(), device=uvs.device) - (
        torch.cumsum(n, 0) - n).repeat_interleave(n)
    x = lo[f, 0] + k % span[f, 0]
    y = lo[f, 1] + k // span[f, 0]
    load.view(-1).index_add_(0, y * tx + x, torch.ones_like(x))
    return int(load.max())


@torch.no_grad()
def dilation(img, mask, n_iters, dtype=torch.float64):
    H, W = mask.shape
    im, m = img.to(dtype), mask.to(dtype)

    def box(x):                                       # (H, W, ...) sums
        p = torch.nn.functional.pad(x.movedim((0, 1), (-2, -1)),
                                    (1, 1, 1, 1)).movedim((-2, -1), (0, 1))
        return sum(p[dy:dy + H, dx:dx + W] for dy in range(3)
                   for dx in range(3))
    for _ in range(n_iters):
        msum = box(m)
        csum = box(im * m[..., None])
        filled = csum / msum[..., None].clamp(min=1e-8)
        im = torch.where(m[..., None] > 0, im, filled)
        m = torch.maximum(m, (msum > 0).to(dtype))
    return im


@torch.no_grad()
def dilation_rel(img, mask, n_iters, out, control=False):
    """The program's dilated atlas `out` against `dilation` in float64:
    relative L2 distance; with `control`, the dilation in bfloat16 takes
    the program's place."""
    ref = dilation(img, mask, n_iters)
    if control:
        out = dilation(img, mask, n_iters, torch.bfloat16)
    if out.shape != ref.shape:
        return float("inf")
    return float(torch.linalg.vector_norm(out.double() - ref)
                 / torch.linalg.vector_norm(ref).clamp_min(1e-30))
