"""Model FLOPs of recorded calls, counted by `torch.utils.flop_counter.
FlopCounterMode` over the plain reference modules on the `meta` device
(no memory, no compute): every matmul, conv and the written-out
attention's two products, whatever the program runs."""
import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["call_flops"]

_CACHE = {}


def call_flops(key, make, method, sig):
    """FLOPs of one call of `make()`'s `method` on the arguments that the
    signature `sig` (`capture.signature` of (args, kwargs)) records."""
    from portbench.harness.capture import from_signature
    ck = (key, sig)
    if ck not in _CACHE:
        with torch.device("meta"):
            mod = make()
        args = from_signature(sig[0])
        kwargs = from_signature(sig[1])
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            getattr(mod, method)(*args, **kwargs)
        _CACHE[ck] = int(fc.get_total_flops())
    return _CACHE[ck]
