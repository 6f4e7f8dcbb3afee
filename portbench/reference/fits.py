"""Plain references of the fits' row gather and of one optimiser step.

- `gather_mismatch`: `x[idx]` along dim 0, by plain indexing, against
  the program's gather, bit for bit (the gather moves values, it rounds
  nothing);
- `adam_step_error`: one Adam step (`torch.optim.Adam`'s arithmetic:
  bias-corrected moments, eps added to the corrected root) recomputed in
  float64 from the step's own inputs (parameters, gradients, moments,
  step count and hyper-parameters) against the program's new
  parameters.

Each takes `control`: the same work a precision below the program's, put
in the program's place, which the check has to refuse.
"""
import torch

__all__ = ["lower", "gather_mismatch", "adam_update", "adam_step_error"]


def lower(x):
    """`x` rounded to the precision below its own: float32 to bfloat16,
    bfloat16 or float16 to float8 (e4m3); integers as they are."""
    if not x.is_floating_point():
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float8_e4m3fn).to(x.dtype)
    return x.to(torch.bfloat16).to(x.dtype)


def _bits(x):
    if not x.is_floating_point():
        return x
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


@torch.no_grad()
def gather_mismatch(x, idx, out, control=False):
    """Elements of `out` that differ from `x[idx]` (rows of `x` along dim
    0, `idx` of any shape), compared bit for bit; with `control`, `x` is
    rounded a precision lower first and takes the program's place."""
    flat = idx.reshape(-1).long()
    ref = x[flat].reshape(*idx.shape, *x.shape[1:])
    if control:
        out = lower(x)[flat].reshape(ref.shape)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return float("inf")
    return float((_bits(out) != _bits(ref)).sum())


def adam_update(p, g, m, v, step, lr, betas, eps, weight_decay=0.0,
                dtype=torch.float64):
    """The parameter after one Adam step, every operand and operation in
    `dtype`; `m`, `v` None before the first step, `step` the steps
    taken."""
    b1, b2 = betas
    p, g = p.to(dtype), g.to(dtype)
    m = torch.zeros_like(p) if m is None else m.to(dtype)
    v = torch.zeros_like(p) if v is None else v.to(dtype)
    if weight_decay:
        g = g + weight_decay * p
    t = step + 1
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    return p - (lr / bc1) * m / (v.sqrt() / bc2 ** 0.5 + eps)


@torch.no_grad()
def adam_step_error(leaves, device, control=False):
    """One captured step (`leaves`: each parameter's `p`, `g`, `m`, `v`,
    `step`, `new` and its group's `lr`, `betas`, `eps`, `weight_decay`):
    the worst parameter's |program's change - reference's change|_2 over
    the larger of the reference change's norm and the median
    parameter's. With `control`, the step in bfloat16 takes the program's
    place."""
    errs, norms = [], []
    for leaf in leaves:
        p = leaf["p"].to(device)
        g = leaf["g"].to(device) if leaf["g"] is not None \
            else torch.zeros_like(p)
        m, v = (None if leaf[k] is None else leaf[k].to(device)
                for k in ("m", "v"))
        args = (p, g, m, v, leaf["step"], leaf["lr"], leaf["betas"],
                leaf["eps"], leaf.get("weight_decay", 0.0))
        ref = adam_update(*args) - p.double()
        new = adam_update(*args, dtype=torch.bfloat16) if control \
            else leaf["new"].to(device)
        if new.shape != p.shape:
            return float("inf")
        d = new.double() - p.double()
        errs.append(float(torch.linalg.vector_norm(d - ref)))
        norms.append(float(torch.linalg.vector_norm(ref)))
    if not errs:
        return float("inf")
    med = sorted(norms)[len(norms) // 2]
    return max(e / max(n, med, 1e-30) for e, n in zip(errs, norms))
