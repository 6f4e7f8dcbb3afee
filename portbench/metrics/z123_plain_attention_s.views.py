"""The plain attention a request: the device seconds of the kernels
launched inside the benchmark's ranges around `_plain_attention` and
`_chunked_attention` (`attn_plain`, `attn_chunked`: the calls that
`uses_flash` keeps off the kernel, Zero123++'s levels 1-3, its cross-
attentions, the vision tower and the VAE's mid-attention), over the
window's requests."""

NAMES = ("portbench.attn_plain", "portbench.attn_chunked")


def read(ctx):
    tr, recs = ctx.get("trace"), ctx["records"]
    if not tr or not recs:
        return None
    dev = sum(tr["range_device_s"].get(n, 0.0) for n in NAMES)
    if dev <= 0:
        return None
    return dev / len(recs)
