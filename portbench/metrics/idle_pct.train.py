"""Share of the profiled sub-window of training steps with no kernel, copy or set running on
the card, in %."""
from portbench.lib.readers import idle_pct


def read(r):
    return idle_pct(r)
