"""Activations with numerically safe gradients (counterpart of
`mvedit_tpu/ops/activation.py`)."""
import torch

__all__ = ["trunc_exp"]


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    """exp(x) whose gradient is exp(clip(x, -15, 15)) * dx: the forward is
    plain exp, only the gradient is truncated, so density fields can
    saturate without producing inf gradients."""
    return _TruncExp.apply(x)
