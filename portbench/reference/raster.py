"""Plain reference of the raster selection: a frozen copy of the port's
`kernels/raster_select.py::prepare_coeffs`, `select_reference` and
`raster_select_reference` (the nearest covering candidate of every pixel
of a tile, every op rounding on its own in the kernel's order). The
program's kernel is bit-equal to it by design, so the check compares
exactly."""
import torch

__all__ = ["raster_select_reference", "BIG"]

BIG = 3.0e38                 # key of a pixel that nothing covers


def prepare_coeffs(pts, faces, cand, cand_valid, cull_backface=False):
    """(T, K, 12) affine coefficients of the candidates, as
    `select_pallas.prepare_coeffs` builds them: cols 0-8 = (alpha, beta,
    gamma) of edges 0..2, sign-folded so that covered <=> all three >= 0,
    invalid or degenerate candidates (0, 0, -1); cols 9-11 = (zx, zy, zc)
    of the 1/z plane, divided by the signed area. Every op rounds on its
    own, in the order the kernel evaluates them."""
    p = pts[faces[cand.long()]]                       # (T, K, 3, 3)
    ax, ay, az = p[..., 0, 0], p[..., 0, 1], p[..., 0, 2]
    bx, by, bz = p[..., 1, 0], p[..., 1, 1], p[..., 1, 2]
    cx, cy, cz = p[..., 2, 0], p[..., 2, 1], p[..., 2, 2]
    al0, be0, ga0 = -(cy - by), cx - bx, bx * cy - cx * by
    al1, be1, ga1 = -(ay - cy), ax - cx, cx * ay - ax * cy
    al2, be2, ga2 = -(by - ay), bx - ax, ax * by - bx * ay
    area = ga0 + ga1 + ga2
    if cull_backface:
        ok = cand_valid & (area > 1e-12)
        sgn = torch.ones_like(area)
    else:
        ok = cand_valid & (area.abs() > 1e-12)
        sgn = torch.sign(area)
    tiny = torch.where(area >= 0, torch.full_like(area, 1e-12),
                       torch.full_like(area, -1e-12))
    inv_area = torch.reciprocal(torch.where(area.abs() < 1e-12, tiny, area))
    iza, izb, izc = (torch.reciprocal(z) for z in (az, bz, cz))
    zx = (al0 * iza + al1 * izb + al2 * izc) * inv_area
    zy = (be0 * iza + be1 * izb + be2 * izc) * inv_area
    zc = (ga0 * iza + ga1 * izb + ga2 * izc) * inv_area
    zero = torch.zeros((), dtype=area.dtype, device=area.device)
    rows = []
    for al, be, ga in ((al0, be0, ga0), (al1, be1, ga1), (al2, be2, ga2)):
        rows += [torch.where(ok, al * sgn, zero),
                 torch.where(ok, be * sgn, zero),
                 torch.where(ok, ga * sgn, -1.0 + zero)]
    return torch.stack(rows + [zx, zy, zc], -1)


@torch.no_grad()
def select_reference(pts, faces, cand, cand_valid, tile, tiles_x,
                     cull_backface=False, tile_chunk=64):
    """The plain version of `select_pallas` on one (T, K) candidate list
    -> (best, key), over chunks of `tile_chunk` tiles so that the
    (tiles, tile^2, K) temporaries stay bounded."""
    T = cand.shape[0]
    P = tile * tile
    dev = pts.device
    pid = torch.arange(P, device=dev)
    best = torch.empty((T, P), dtype=torch.int32, device=dev)
    bkey = torch.empty((T, P), dtype=torch.float32, device=dev)
    for t0 in range(0, T, tile_chunk):
        t = torch.arange(t0, min(T, t0 + tile_chunk), device=dev)
        co = prepare_coeffs(pts.float(), faces, cand[t], cand_valid[t],
                            cull_backface)                  # (C, K, 12)
        qx = ((t[:, None] % tiles_x) * tile + pid % tile).float() + 0.5
        qy = ((t[:, None] // tiles_x) * tile + pid // tile).float() + 0.5
        qx, qy = qx[:, :, None], qy[:, :, None]             # (C, P, 1)

        def aff(i):
            return (co[:, None, :, i] * qx + co[:, None, :, i + 1] * qy
                    + co[:, None, :, i + 2])                # (C, P, K)
        covered = (aff(0) >= 0) & (aff(3) >= 0) & (aff(6) >= 0)
        key = -aff(9)
        # a covered key that is not below BIG (NaN, +inf) is never taken,
        # as the kernel's strict `key < best` scan never takes it
        key = torch.where(covered & (key < BIG), key,
                          torch.full_like(key, BIG))
        k, i = key.min(-1)          # first index of the minimum
        best[t] = i.int()
        bkey[t] = k
    return best, bkey


@torch.no_grad()
def raster_select_reference(pts, faces, tile_tris, tile_valid, tile,
                            tiles_x, cull_backface=False, big_tris=None,
                            big_valid=None):
    """The plain version of `raster_select`: (best, key, face), from
    `select_reference` on the joined (T, Kt + Kb) candidate axis."""
    cand, cval = tile_tris.long(), tile_valid.bool()
    if big_tris is not None:
        T = cand.shape[0]
        cand = torch.cat([cand, big_tris.long()[None].expand(T, -1)], 1)
        cval = torch.cat([cval, big_valid.bool()[None].expand(T, -1)], 1)
    best, key = select_reference(pts, faces.long(), cand, cval, tile,
                                 tiles_x, cull_backface)
    face = torch.where(key < BIG, cand.gather(1, best.long()),
                       torch.full_like(cand[:, :1], -1))
    return best, key, face

