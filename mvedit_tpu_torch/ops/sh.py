"""Closed-form real spherical-harmonics direction encoding (counterpart of
`mvedit_tpu/ops/sh.py`).

Inputs are unit (or [-1, 1]) directions; output dim = degree**2, degrees
1-4 (the triplane decoder's view directions take 4 -> 16 features).
Autograd gives the input gradients.
"""
import torch

__all__ = ["sh_encode"]

# real SH constants (instant-ngp / torch-ngp normalisation)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_encode(dirs, degree=4, size=1.0):
    """(..., 3) directions in [-size, size] -> (..., degree**2) features.
    Raises ValueError for a degree outside 1..4."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh_encode supports degree in [1, 4], got {degree}")
    d = dirs / size
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
                _C2[3] * xz, _C2[4] * (xx - yy)]
    if degree > 3:
        out += [_C3[0] * y * (3.0 * xx - yy),
                _C3[1] * xy * z,
                _C3[2] * y * (4.0 * zz - xx - yy),
                _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _C3[4] * x * (4.0 * zz - xx - yy),
                _C3[5] * z * (xx - yy),
                _C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, -1)
