"""The least time of the three U-Nets (``Regular.0-2``), counted from the shapes, over its
device busy ms per map, in %."""
from portbench.lib.readers import roofline

LAYERS = ('Regular.0', 'Regular.1', 'Regular.2')


def read(r):
    return roofline(r, LAYERS, LAYERS)
