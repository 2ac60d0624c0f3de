"""Device busy ms per step of the forward and the loss: operations
launched from the loop's thread inside the step span, outside Adam's."""


def read(r):
    us = sum(o.dur for o in r.trace.ops if o.main and "train step" in o.spans
             and "optimizer" not in o.spans)
    return us / 1e3 / r.items if us else None
