"""Device busy ms per map of the operations launched inside
the three U-Nets (``Regular.0-2``)."""
from portbench.lib.readers import span_ms

LAYERS = ('Regular.0', 'Regular.1', 'Regular.2')


def read(r):
    return span_ms(r, LAYERS)
