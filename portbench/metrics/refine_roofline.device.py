"""The least time of the refinement (``Refine``), counted from the shapes, over its
device busy ms per map, in %."""
from portbench.lib.readers import roofline

LAYERS = ('Refine',)


def read(r):
    return roofline(r, LAYERS, LAYERS)
