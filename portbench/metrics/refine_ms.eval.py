"""Device busy ms per map of the operations launched inside
the refinement (``Refine``)."""
from portbench.lib.readers import span_ms

LAYERS = ('Refine',)


def read(r):
    return span_ms(r, LAYERS)
