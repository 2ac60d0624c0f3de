"""Device busy ms per map of the operations launched inside
the backbone (``Backbone``)."""
from portbench.lib.readers import span_ms

LAYERS = ('Backbone',)


def read(r):
    return span_ms(r, LAYERS)
