"""The NeRF and DMTet fits a request (`PhaseTimer`'s `nerf_fit` and
`mesh_fit`), averaged over the window's requests."""

NAMES = ("nerf_fit", "mesh_fit")


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any(n in p for p in phases for n in NAMES):
        return None
    return sum(p.get(n, 0.0) for p in phases for n in NAMES) / len(phases)
