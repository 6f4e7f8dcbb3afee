"""Losses (counterpart of `mvedit_tpu/models/losses.py`; the L1 and TV
losses so far). LPIPS comes with its own slice: the mesh phase runs with
`lpips_params=None`, the path the reference takes when LPIPS is off."""
import torch

__all__ = ["l1_loss", "tv_loss"]


def _weighted_mean(err, weight):
    if weight is None:
        return err.mean()
    return (err * torch.broadcast_to(weight, err.shape)).mean()


def _abs(x):
    # the reference's |x| has gradient +1 at x == 0 (torch.abs: 0), and a
    # rendered alpha often equals its target exactly (0 or 1)
    return torch.where(x >= 0, x, -x)


def l1_loss(pred, target, weight=None):
    return _weighted_mean(_abs(pred - target), weight)


def tv_loss(x, target=None, weight=None, power=1.5):
    """Total variation of x (N, C, H, W); with `target`, the TV of the
    difference. `weight` is an elementwise map over the differences."""
    d = x if target is None else x - target
    dh = d[..., 1:, :] - d[..., :-1, :]
    dw = d[..., :, 1:] - d[..., :, :-1]
    if weight is not None:
        wh = torch.minimum(weight[..., 1:, :], weight[..., :-1, :])
        ww = torch.minimum(weight[..., :, 1:], weight[..., :, :-1])
    else:
        wh = ww = None
    lh = _weighted_mean(_abs(dh) ** power, wh)
    lw = _weighted_mean(_abs(dw) ** power, ww)
    return 0.5 * (lh + lw)
