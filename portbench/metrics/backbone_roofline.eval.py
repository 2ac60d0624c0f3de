"""The least time of the backbone (``Backbone``), counted from the shapes, over its
device busy ms per map, in %."""
from portbench.lib.readers import roofline

LAYERS = ('Backbone',)


def read(r):
    return roofline(r, LAYERS, LAYERS)
