"""The whole request's share of the card's bf16 peak: the model FLOPs of
the window's diffusion calls (UNet, ControlNets, VAE; counted on the
plain reference modules on the meta device from each call's recorded
shapes, `reference/flops.py`) over the requests' summed wall times 989
TFLOP/s. The walls are the traced run's host clock, which the profiler
stretches (~30% in a request cell), and the fits, renders and bake are
not counted, so this reads low. In %."""
from portbench.reference.bounds import PEAK_BF16


def read(ctx):
    walls = sum(r["wall"] for r in ctx["records"])
    flops = ctx["system"].model_flops(ctx["sites"])
    if walls <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (walls * PEAK_BF16)
