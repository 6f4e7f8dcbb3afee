"""The bake a request: the program's `bake` phase (`PhaseTimer`'s total of
`pipelines/mvedit_3d.py`'s `phase("bake")`, the `mvedit.bake` range:
extraction, decimation, the texture refine, the UV atlas, the bake and
its dilation, ending in the atlas's copy to the host), averaged over the
window's requests."""


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any("bake" in p for p in phases):
        return None
    return sum(p.get("bake", 0.0) for p in phases) / len(phases)
