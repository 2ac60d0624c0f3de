"""Device busy ms per map of the operations launched inside
the three aggregates (``Homoaggre.0-2``)."""
from portbench.lib.readers import span_ms

LAYERS = ('Homoaggre.0', 'Homoaggre.1', 'Homoaggre.2')


def read(r):
    return span_ms(r, LAYERS)
