"""What the per-layer metrics read: device time by span, the idle share,
utilisation and roofline shares, each from one traced run. A reader that
finds nothing to read returns None, and the metric is left out."""
from __future__ import annotations

from portbench.lib import count
from portbench.lib.peaks import PEAKS


class Reading:
    """One traced run as the readers see it: its trace (``trace``), the
    number of maps or steps profiled (``items``), the unprofiled window's
    host numbers (``host``), the cell's configuration and shapes, and the
    work of one forward counted by :mod:`portbench.lib.count`."""

    def __init__(self, trace, items: int, host: dict, cfg: dict, kind: str):
        self.trace, self.items, self.host = trace, items, host
        self.cfg, self.kind = cfg, kind
        self.shape = cfg[kind]
        self._work = None

    @property
    def work(self) -> dict:
        if self._work is None:
            self._work = count.forward_work(self.cfg, self.shape,
                                            train=self.kind == "train")
        return self._work


def span_ms(r: Reading, names: tuple) -> float | None:
    """Device ms per item of the operations launched inside any of the
    spans ``names``."""
    us = sum(o.dur for o in r.trace.ops if set(names) & set(o.spans))
    return us / 1e3 / r.items if us else None


def roofline(r: Reading, layers: tuple, names: tuple) -> float | None:
    """The layers' least time over their device ms per item, in %."""
    ms = span_ms(r, names)
    if not ms:
        return None
    return 100.0 * sum(count.least_ms(r.work[n]) for n in layers) / ms


def idle_pct(r: Reading) -> float | None:
    w0, w1 = r.trace.window
    if w1 <= w0 or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_us / (w1 - w0))


def mfu(r: Reading, passes: int) -> float | None:
    """``passes`` x the forward's convolution FLOPs per item, over the
    unprofiled window's seconds per item and the bf16 peak, in %."""
    if not r.host["items"]:
        return None
    per_item = r.host["seconds"] / r.host["items"]
    return 100.0 * passes * count.conv_flops(r.work) / (
        per_item * PEAKS["bf16_tensor_flops"])


def step_ops(r: Reading) -> list:
    """A training step's device operations: those launched inside the step
    span from the loop's thread, and the backward's."""
    return [o for o in r.trace.ops if "train step" in o.spans or not o.main]
