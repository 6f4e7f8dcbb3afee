"""The VAE a request: the pipeline's `z123.cond` (the condition's VAE
encode at the grid's size, beside the vision tower at 224 x 224) and
`z123.decode` (the grid's decode) phases, `PhaseTimer` totals over both
passes, averaged over the window's requests."""

NAMES = ("z123.cond", "z123.decode")


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any(n in p for p in phases for n in NAMES):
        return None
    return sum(p.get(n, 0.0) for p in phases for n in NAMES) / len(phases)
