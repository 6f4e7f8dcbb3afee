"""The normal ControlNet a request: the pipeline's `z123.controlnet` phase
(`PhaseTimer` total, one call a step of the normal pass), averaged over
the window's requests."""


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any("z123.controlnet" in p for p in phases):
        return None
    return sum(p.get("z123.controlnet", 0.0) for p in phases) / len(phases)
