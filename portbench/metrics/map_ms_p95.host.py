"""95th percentile of the map latencies (input copy to depth and confidence
on the host) over the unprofiled part of the traced run's window, in ms.
The tail of a host-paced closed loop swings with the host's load from run
to run, so it stands here rather than among the end-to-end metrics."""
import numpy as np


def read(r):
    lat = r.host.get("latencies")
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
