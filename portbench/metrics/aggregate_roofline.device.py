"""The least time of the three aggregates (``Homoaggre.0-2``), counted from the shapes, over its
device busy ms per map, in %."""
from portbench.lib.readers import roofline

LAYERS = ('Homoaggre.0', 'Homoaggre.1', 'Homoaggre.2')


def read(r):
    return roofline(r, LAYERS, LAYERS)
