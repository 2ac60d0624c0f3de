"""Scenes and the tie rule of the port's fusion tests (numpy only, so the
card tests, which run without JAX, use them too).

A scene is a tilted plane with a box in front of it, seen by cameras turned
a few degrees about random axes, its depth maps with relative noise and
holes (zero depth), and each camera turned again by a fraction of a degree
after rendering, so that reprojections spread over the consistency
thresholds instead of all passing.

The tie rule: masks and counts are compared exactly, except at pixels where
a compared quantity lies within ``TIE`` (relative) of its threshold, where
one rounding step of f32 may flip the comparison. :func:`check_ties` counts
the pixels that differ, each of which must lie within the tie distance, and
prints that count beside the number of pixels within it.
"""
from __future__ import annotations

import numpy as np

TIE = 1e-5                 # relative distance of a tie from its threshold
MAX_TIE_SHARE = 1e-4       # pixels that may differ (all of them ties)


def _rotation(rng, deg):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    t = np.radians(deg) * rng.randn()
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def fusion_scene(seed: int = 0, nviews: int = 5, h: int = 32, w: int = 48,
                 focal: float = 60.0, noise: float = 2e-3,
                 jitter: float = 0.3, holes: float = 0.02):
    """(depths (V, H, W), K (V, 3, 3), E (V, 4, 4)) float32 from ``seed``."""
    rng = np.random.RandomState(seed)
    ks, es, ds = [], [], []
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    for v in range(nviews):
        k = np.array([[focal * (1 + 0.02 * rng.randn()), 0,
                       w / 2 + rng.randn()],
                      [0, focal * (1 + 0.02 * rng.randn()),
                       h / 2 + rng.randn()],
                      [0, 0, 1]])
        r = _rotation(rng, 3.0)
        c = np.array([v * 6.0 - 12.0, rng.randn() * 3, 0.0])
        e = np.eye(4)
        e[:3, :3], e[:3, 3] = r, -r @ c
        ray = r.T @ np.linalg.inv(k) @ pix      # world direction, cam z = 1
        # plane z = 100 + 0.1 x; a box face z = 85 over |x| < 15, |y| < 10
        n1 = np.array([-0.1, 0.0, 1.0])
        lam = (100.0 - n1 @ c) / (n1 @ ray)
        lam2 = (85.0 - c[2]) / ray[2]
        hit = c[:, None] + lam2 * ray
        box = (np.abs(hit[0]) < 15) & (np.abs(hit[1]) < 10) & (lam2 < lam)
        d = np.where(box, lam2, lam).reshape(h, w)
        d = d * (1 + noise * rng.randn(h, w))
        d[rng.rand(h, w) < holes] = 0.0
        e[:3, :3] = _rotation(rng, jitter) @ e[:3, :3]
        ks.append(k)
        es.append(e)
        ds.append(d)
    return (np.stack(ds).astype(np.float32), np.stack(ks).astype(np.float32),
            np.stack(es).astype(np.float32))


def near(q, thresholds) -> np.ndarray:
    """Where ``q`` lies within TIE (relative) of any of ``thresholds``
    (broadcast against a new leading axis); NaN is never near."""
    q = np.asarray(q, np.float64)
    t = np.asarray(thresholds, np.float64).reshape(
        (-1,) + (1,) * q.ndim)
    with np.errstate(invalid="ignore"):
        return (np.abs(q[None] - t) <= TIE * np.maximum(np.abs(t), 1e-30)
                ).any(0)


def near_integer(x) -> np.ndarray:
    """Where ``x`` lies within TIE (relative, at least TIE absolute) of an
    integer: a floor or a rounding to a cell may go either way."""
    x = np.asarray(x, np.float64)
    with np.errstate(invalid="ignore"):
        return np.abs(x - np.round(x)) <= TIE * np.maximum(np.abs(x), 1.0)


def check_ties(what: str, got, want, tie_px) -> int:
    """``got`` equals ``want`` but where ``tie_px`` (broadcast to their
    shape) is set, and differs on at most MAX_TIE_SHARE of the entries.
    Prints and returns the count of entries that differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tie_px = np.broadcast_to(np.asarray(tie_px, bool), want.shape)
    differ = got != want
    print(f"{what}: {int(differ.sum())} of {differ.size} entries differ, "
          f"{int(tie_px.sum())} lie within {TIE:g} of a threshold")
    assert not (differ & ~tie_px).any(), (
        f"{what}: {int((differ & ~tie_px).sum())} entries differ away "
        f"from every threshold")
    assert differ.sum() <= MAX_TIE_SHARE * differ.size, what
    return int(differ.sum())


def close(what: str, got, want, skip=None, rtol: float = 1e-5) -> None:
    """Continuous outputs within ``rtol`` of the values' scale (NaN where
    ``want`` is NaN), but where ``skip`` is set (a tie upstream)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    keep = np.ones(want.shape, bool) if skip is None else ~np.broadcast_to(
        np.asarray(skip, bool), want.shape)
    nan = np.isnan(want)
    assert (np.isnan(got) == nan)[keep].all(), f"{what}: NaN differs"
    ok = keep & ~nan
    scale = max(np.abs(want[ok]).max(initial=0.0), 1e-30)
    err = np.abs(got - want)[ok].max(initial=0.0)
    print(f"{what}: max |diff| {err:.3g} of scale {scale:.3g}, "
          f"{int((got == want)[ok].sum())} of {int(ok.sum())} equal")
    assert err <= rtol * scale, what
