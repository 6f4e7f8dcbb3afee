"""The device's idle share of the traced window: 100 less the union of
kernel, memcpy and memset intervals over the window's length. The
profiler adds host time, so this is an upper bound. In %."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
