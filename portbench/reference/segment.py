"""Plain reference of the fixed-order segment sum: the sum of each target
row's contributions in float64, and the control, the same sum accumulated
in bfloat16 (the step below the program's float32 accumulation)."""
import torch

__all__ = ["segment_error", "bf16_accumulated"]

# sequential bfloat16 additions a row, at most: a longer row's
# contributions are first folded in float32 into this many partials
SERIAL = 2048


@torch.no_grad()
def bf16_accumulated(i, v, size):
    """Each row's contributions added one after another in bfloat16, in
    their order, rounding after every add (rows past `SERIAL` contributions
    add `SERIAL` float32 partials that way)."""
    C = v.shape[1]
    order = torch.sort(i, stable=True).indices
    i, v = i[order], v[order].float()
    counts = torch.bincount(i, minlength=size)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(i.shape[0], device=i.device) - starts[i]
    key = i * SERIAL + rank % SERIAL
    uk, inv = torch.unique(key, return_inverse=True)
    part = torch.zeros((uk.shape[0], C), dtype=torch.float32,
                       device=v.device).index_add_(0, inv, v)
    urow, uslot = uk // SERIAL, uk % SERIAL
    by_slot = torch.sort(uslot, stable=True).indices
    bounds = torch.searchsorted(uslot[by_slot], torch.arange(
        SERIAL + 1, device=v.device)).tolist()
    acc = torch.zeros((size, C), dtype=torch.bfloat16, device=v.device)
    for k in range(SERIAL):
        if bounds[k] == bounds[k + 1]:
            break
        sel = by_slot[bounds[k]:bounds[k + 1]]
        r = urow[sel]
        acc[r] = (acc[r].float() + part[sel]).to(torch.bfloat16)
    return acc


@torch.no_grad()
def segment_error(idx, vals, size, out, control=False):
    """The accumulation's error: max over rows and channels of |out -
    exact| less half a unit in the last place of `out`'s dtype at |exact|
    (the output's own final rounding), over 2^-7 sum |x| (bfloat16's
    machine epsilon times the row's absolute sum). A float32 sum, kept or
    rounded once to bfloat16, reads nearly 0. With `control` the
    bfloat16-accumulated sum takes `out`'s place."""
    idx = idx.long()
    keep = (idx >= 0) & (idx < size)
    i, v = idx[keep], vals[keep]
    C = vals.shape[1]
    exact = torch.zeros((size, C), dtype=torch.float64, device=vals.device)
    exact.index_add_(0, i, v.double())
    scale = torch.zeros_like(exact).index_add_(0, i, v.double().abs())
    if control:
        out = bf16_accumulated(i, v, size)
    mant = {torch.bfloat16: 7, torch.float16: 10}.get(out.dtype, 23)
    _, e = torch.frexp(exact)
    half_ulp = torch.ldexp(torch.ones_like(exact), e - 1 - mant) * 0.5
    err = ((out.double() - exact).abs() - half_ulp).clamp_min(0) / (
        scale * 2.0 ** -7 + 1e-300)
    return float(err.max()) if err.numel() else 0.0
