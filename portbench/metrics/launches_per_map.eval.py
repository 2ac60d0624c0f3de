"""Device operations (kernels, copies, sets) per map in the profiled
sub-window: a count that repeats exactly."""


def read(r):
    return len(r.trace.ops) / r.items if r.trace.ops else None
