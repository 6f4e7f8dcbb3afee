"""The training iteration's share of the card's bf16 peak: one
iteration's model FLOPs (the LoRA UNet's forward and backward, the
decoder's render and LPIPS forward and backward; counted on the plain
reference modules on the meta device, `configs/<config>.py::step_flops`)
times the window's iterations, over the window's wall times 989 TFLOP/s.
The text tower's forward is not counted, and the window is the traced
run's host clock, which the profiler stretches, so this reads low. In %."""
from portbench.reference.bounds import PEAK_BF16


def read(ctx):
    win = ctx["win"]
    n, w = win["attempted"], win["window_s"]
    if not n or w <= 0:
        return None
    return 100.0 * ctx["system"].step_flops() * n / (w * PEAK_BF16)
