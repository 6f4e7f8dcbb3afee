"""The segment sum's share of its roofline: the least time of every call
at `ops/segment.py`'s entry (the fits' gradient sums, backward included;
`reference/bounds.py::segment_bound_s` of its recorded shapes), over the
device time of the kernels launched inside the benchmark's range around
it. In %."""
from portbench.reference.bounds import segment_call_bound


def read(ctx):
    tr, sites = ctx.get("trace"), ctx["sites"].sites
    if "segment_sum" not in sites or not tr:
        return None
    dev = tr["range_device_s"].get("portbench.segment_sum", 0.0)
    if dev <= 0:
        return None
    bound = sum(c * segment_call_bound(sig)
                for sig, c in sites["segment_sum"].sigs.items())
    return 100.0 * bound / dev
