"""Device busy ms per step of the backward: the operations the autograd
engine launched from its own thread."""


def read(r):
    us = sum(o.dur for o in r.trace.ops if not o.main)
    return us / 1e3 / r.items if us else None
