"""A training step's least time over its device busy ms, in %: 3 passes
(forward, input gradients, weight gradients) of each layer's least time,
counted from the shapes, plus Adam's bytes over the bandwidth."""
from portbench.lib import count
from portbench.lib.peaks import PEAKS
from portbench.lib.readers import step_ops


def read(r):
    us = sum(o.dur for o in step_ops(r))
    if not us:
        return None
    n_params = sum(w["params"] for w in r.work.values())
    least = sum(count.least_ms(w, 3) for w in r.work.values()) + 1e3 * \
        count.adam_bytes(n_params) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / (us / 1e3 / r.items)
