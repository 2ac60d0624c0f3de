"""Device busy ms per map launched inside the model call but outside the
backbone, aggregate, U-Net and refinement spans: the hypotheses, the
regressions and the glue between layers."""
from portbench.lib.harness import loop_module

LAYERS = loop_module("eval").LAYERS


def read(r):
    us = sum(o.dur for o in r.trace.ops
             if "model call" in o.spans and not set(LAYERS) & set(o.spans))
    return us / 1e3 / r.items if us else None
