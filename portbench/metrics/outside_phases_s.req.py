"""Endpoint self time a request: its wall less the sum of the pipeline's
`PhaseTimer` totals (mesh loading and its renders, the prompt encode,
extraction and the GLB write), averaged over the window's requests."""


def read(ctx):
    recs, phases = ctx["records"], ctx["phases"]
    if not phases or len(phases) != len(recs):
        return None
    return sum(r["wall"] - sum(p.values())
               for r, p in zip(recs, phases)) / len(recs)
