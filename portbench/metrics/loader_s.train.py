"""The CLI's loader a window iteration: its own `times.loader` (host
clock around `next(data)`, on the step's thread), averaged over the
window's iterations."""


def read(ctx):
    v = ctx["win"].get("loader_s")
    return sum(v) / len(v) if v else None
