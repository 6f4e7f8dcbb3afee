"""The two denoise passes a request (`PhaseTimer`'s `denoise_p1+vae_dec`
and `denoise_p2+vae_enc+solver`), averaged over the window's requests."""

NAMES = ("denoise_p1+vae_dec", "denoise_p2+vae_enc+solver")


def read(ctx):
    phases = ctx["phases"]
    if not phases or not any(n in p for p in phases for n in NAMES):
        return None
    return sum(p.get(n, 0.0) for p in phases for n in NAMES) / len(phases)
