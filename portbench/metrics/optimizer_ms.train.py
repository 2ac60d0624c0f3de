"""Device busy ms per step inside ``optimizer.step()`` (Adam)."""
from portbench.lib.readers import span_ms


def read(r):
    return span_ms(r, ("optimizer",))
