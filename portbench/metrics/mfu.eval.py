"""2 x the multiply-adds of every convolution of the forward, counted from
the shapes, per map, over the unprofiled window's seconds per map and the
bf16 tensor-core peak, in %."""
from portbench.lib.readers import mfu


def read(r):
    return mfu(r, 1)
