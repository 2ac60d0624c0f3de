"""Multi-distribution fitting of depth hypotheses — the "MDF" core (port of
``mdfnet_tpu/ops/fitting.py``).

Closed-form per-pixel curve fits on the probability volume give the next
stage's search radius. Everything runs in f32 without gradients, as in the
reference (net/unit/depthhypos.py:40 wraps fitting in no_grad).
"""
from __future__ import annotations

import torch

from mdfnet_tpu_torch.ops.sample import resize_bilinear_2x

_PROB_FLOOR = 1e-40


def uniform_hypotheses(depth_range: torch.Tensor, ndepths: int) -> torch.Tensor:
    """Stage-0 hypotheses: D planes evenly spaced over [dmin, dmax].

    Returns (B, D, 1, 1)."""
    dmin = depth_range[:, 0].float()
    dmax = depth_range[:, 1].float()
    step = (dmax - dmin) / (ndepths - 1)
    steps = torch.arange(ndepths, dtype=torch.float32,
                         device=depth_range.device)
    hypos = dmin[:, None] + steps[None, :] * step[:, None]
    return hypos[:, :, None, None]


def fit_laplace(depth: torch.Tensor, prob_volume: torch.Tensor,
                depth_hypos: torch.Tensor) -> torch.Tensor:
    """Laplace scale 1 / |Σxy / Σxx| with x = |hypo - depth|,
    y = log max(p, 1e-40). Returns (B, H, W)."""
    y = torch.log(torch.clamp(prob_volume.float(), min=_PROB_FLOOR))
    x = torch.abs(depth_hypos.float() - depth.float()[:, None])
    b = torch.abs(torch.sum(x * y, dim=1) / torch.sum(x * x, dim=1))
    return 1.0 / b


def fit_gauss1(depth: torch.Tensor, prob_volume: torch.Tensor,
               depth_hypos: torch.Tensor) -> torch.Tensor:
    """Gaussian width |-1/b0| of the least-squares parabola
    log p = b0 x² + b1 x + b2 over the D hypotheses, b0 by Cramer's rule on
    the 3x3 normal equations. Returns (B, H, W)."""
    z = torch.log(torch.clamp(prob_volume.float(), min=_PROB_FLOOR))
    x = depth_hypos.float().expand_as(z)
    x2 = x * x
    d = float(z.shape[1])
    s4 = torch.sum(x2 * x2, dim=1)
    s3 = torch.sum(x2 * x, dim=1)
    s2 = torch.sum(x2, dim=1)
    s1 = torch.sum(x, dim=1)
    v0 = torch.sum(x2 * z, dim=1)
    v1 = torch.sum(x * z, dim=1)
    v2 = torch.sum(z, dim=1)
    det = (s4 * (s2 * d - s1 * s1)
           - s3 * (s3 * d - s1 * s2)
           + s2 * (s3 * s1 - s2 * s2))
    det0 = (v0 * (s2 * d - s1 * s1)
            - s3 * (v1 * d - s1 * v2)
            + s2 * (v1 * s1 - s2 * v2))
    return torch.abs(-1.0 / (det0 / det))


def fit_gauss0(depth: torch.Tensor, prob_volume: torch.Tensor,
               depth_hypos: torch.Tensor) -> torch.Tensor:
    """Gaussian width |-1/b0| of the centred parabola log p = b0 (x - d)² +
    b1 over the D hypotheses, from the 2x2 normal equations in closed form.
    Returns (B, H, W)."""
    z = torch.log(torch.clamp(prob_volume.float(), min=_PROB_FLOOR))
    x = depth_hypos.float().expand_as(z)
    q = (x - depth.float()[:, None]) ** 2
    d = float(z.shape[1])
    s2 = torch.sum(q * q, dim=1)
    s1 = torch.sum(q, dim=1)
    v0 = torch.sum(q * z, dim=1)
    v1 = torch.sum(z, dim=1)
    det = s2 * d - s1 * s1
    return torch.abs(-1.0 / ((v0 * d - s1 * v1) / det))


@torch.no_grad()
def atv_hypos(depth: torch.Tensor | None, exp_deviation: torch.Tensor | None,
              depth_range: torch.Tensor, ndepths: int,
              eps: float = 1e-12) -> torch.Tensor:
    """Adaptive-thin-volume hypotheses (reference depthhypos.py:218-253):
    uniform planes at stage 0 (``depth is None``); later, the band [depth -
    min(depth, dev), depth + dev] around the fine-scale ``depth`` (B, H, W),
    with the coarse deviation ``exp_deviation`` (B, H/2, W/2) upsampled
    2x bilinear. Both are taken without gradient. Returns (B, D, H, W)
    ((B, D, 1, 1) at stage 0)."""
    if depth is None:
        return uniform_hypotheses(depth_range, ndepths)
    depth = depth.float()
    dev = resize_bilinear_2x(exp_deviation.float())
    low = -torch.minimum(depth, dev)
    step = (dev - low) / (ndepths - 1)
    i = torch.arange(ndepths, dtype=torch.float32,
                     device=depth.device).reshape(1, ndepths, 1, 1)
    return depth[:, None] + low[:, None] + step[:, None] * i + eps


_FITTERS = {"gauss0": fit_gauss0, "gauss1": fit_gauss1,
            "laplace": fit_laplace}


@torch.no_grad()
def refined_hypotheses(depth: torch.Tensor, depth_range: torch.Tensor,
                       prob_volume: torch.Tensor, depth_hypos: torch.Tensor,
                       *, ndepths: int, curve_class: str,
                       prob_thresh: float) -> torch.Tensor:
    """Next-stage (B, D, 2H, 2W) hypotheses from a fitted probability curve.

    1. fit the curve width s on the previous stage's volume;
    2. 2x-bilinear-upsample s and depth to the next scale;
    3. radius: gauss0/gauss1 sqrt(-s ln t), laplace |s ln t|;
    4. clamp to [1e-6, global range / 2], then to 20% of each item's range;
    5. lay ndepths planes over [depth - r/2, depth + r/2];
    6. clamp the planes into [dmin, dmax].
    """
    if curve_class not in _FITTERS:
        raise ValueError(f"unknown curve class {curve_class!r}")
    dmin = depth_range[:, 0].float()
    dmax = depth_range[:, 1].float()
    s = _FITTERS[curve_class](depth, prob_volume, depth_hypos)
    s = resize_bilinear_2x(s)
    depth = resize_bilinear_2x(depth.float())

    # log of the f32 threshold, as the reference computes it
    log_t = float(torch.log(torch.tensor(prob_thresh, dtype=torch.float32)))
    if curve_class in ("gauss0", "gauss1"):
        res = torch.sqrt(-1.0 * s * log_t)
    else:
        res = torch.abs(s * log_t)
    # the global clamp spans the whole batch (reference depthhypos.py:58)
    global_half_range = (dmax.max() - dmin.min()) / 2.0
    res = torch.minimum(res.clamp_min(1e-6), global_half_range)
    res = torch.minimum(res, ((dmax - dmin) * 0.2)[:, None, None])

    interval = res / (ndepths - 1)
    steps = torch.arange(ndepths, dtype=torch.float32,
                         device=depth.device).reshape(1, ndepths, 1, 1)
    hypos = (depth - 0.5 * res)[:, None] + interval[:, None] * steps
    return torch.minimum(torch.maximum(hypos, dmin[:, None, None, None]),
                         dmax[:, None, None, None])
