"""Attention's share of its roofline: the least time of every
`dot_product_attention` call of the window (`reference/bounds.py::
flash_bound_s` of its recorded shapes), over the device time of the kernels
launched inside the benchmark's ranges around that entry, whatever
implements it. In %."""
from portbench.reference.bounds import attention_call_bound


def read(ctx):
    tr, sites = ctx.get("trace"), ctx["sites"].sites
    names = [n for n in sites if n == "attention"
             or n.startswith("attention.")]
    dev = sum(tr["range_device_s"].get(f"portbench.{n}", 0.0)
              for n in names) if tr else 0.0
    if dev <= 0:
        return None
    bound = sum(c * attention_call_bound(sig) for n in names
                for sig, c in sites[n].sigs.items())
    return 100.0 * bound / dev
