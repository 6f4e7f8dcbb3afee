"""The CLI's step a window iteration: its own `times.step` (host clock
from the batch's copy to the card to the cache's scatter, which waits for
the card), averaged over the window's iterations."""


def read(ctx):
    v = ctx["win"].get("step_s")
    return sum(v) / len(v) if v else None
