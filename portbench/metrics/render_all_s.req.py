"""Render-all a request (`PhaseTimer`'s `render_all`), averaged over the
window's requests."""


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any("render_all" in p for p in phases):
        return None
    return sum(p.get("render_all", 0.0) for p in phases) / len(phases)
