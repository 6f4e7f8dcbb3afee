"""Zero123++'s UNet passes a request: the pipeline's `z123.write` and
`z123.read` phases (`PhaseTimer` totals over both passes of a request, RGB
and normal, each step's write pass of the condition latent and read pass
of the grid's), averaged over the window's requests."""

NAMES = ("z123.write", "z123.read")


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any(n in p for p in phases for n in NAMES):
        return None
    return sum(p.get(n, 0.0) for p in phases for n in NAMES) / len(phases)
