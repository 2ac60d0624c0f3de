"""3 x the forward's convolution FLOPs (the forward, the input gradients,
the weight gradients; no recomputation) per step, over the unprofiled
window's seconds per step and the bf16 tensor-core peak, in %."""
from portbench.lib.readers import mfu


def read(r):
    return mfu(r, 3)
