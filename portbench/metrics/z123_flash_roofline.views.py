"""The flash kernel's share of its roofline in Zero123++: the least time of
every `dot_product_attention` call that took the kernel path
(`reference/bounds.py::attention_call_bound` of its recorded shapes: level
0's write and read self-attentions), over the device time of the kernels
launched inside the benchmark's range around the kernel's entry
(`attn_kernel`). In %."""
from portbench.reference.bounds import attention_call_bound


def read(ctx):
    tr, sites = ctx.get("trace"), ctx["sites"].sites
    if not tr or "attn_kernel" not in sites:
        return None
    dev = tr["range_device_s"].get("portbench.attn_kernel", 0.0)
    if dev <= 0:
        return None
    bound = sum(c * attention_call_bound(sig)
                for sig, c in sites["attn_kernel"].sigs.items())
    return 100.0 * bound / dev
