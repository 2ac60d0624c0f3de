"""2 x the multiply-adds of every convolution of the forward, counted from
the shapes, per map, over the card's busy seconds per map in the profiled
sub-window and the bf16 tensor-core peak, in %: the share of the peak in
the time the card works, which the host's pace does not reach."""
from portbench.lib import count
from portbench.lib.peaks import PEAKS


def read(r):
    if not r.trace.busy_us:
        return None
    per_item = r.trace.busy_us * 1e-6 / r.items
    return 100.0 * count.conv_flops(r.work) / (
        per_item * PEAKS["bf16_tensor_flops"])
