"""Synthetic multi-view scenes drawn from a seed: a frozen copy of the port's
generators (``make_plane_scene``, ``make_structured_scene`` of
``mdfnet_tpu_torch/data/synthetic.py``), rewritten in torch to run on the
card for a batch of scenes at once, in float64 as the originals compute.

A scene is a textured surface seen by ``nviews`` cameras translated along
x (world -> camera extrinsics, shared intrinsics), with the analytic depth
of view 0. The seed draws each scene's surface, depth, tilt, texture offset
and structure, from one stratified set (:func:`draw`); the sizes, views,
baseline and focal come from the cell, so every seed gives the same
amount of work. The depth range is DTU's for every scene, or, with
``range_follows_depth``, DTU's shifted with the scene's stratum of base
depths, as each scene's own cameras give it: scenes of one set then have
ranges 200 / n apart, and an answer of another scene reads far off.
"""
from __future__ import annotations

import math

import torch

DEPTH_RANGE = (425.0, 935.0)
BASE = (560.0, 760.0)                 # base depths are drawn in this range
STRUCTURES = ("plane", "steps", "sphere", "ridges")
N_MARCH = 700


def _texture(u, v):
    """Smooth, high-frequency RGB texture over plane coordinates."""
    r = 0.5 + 0.5 * torch.sin(0.13 * u) * torch.cos(0.07 * v)
    g = 0.5 + 0.5 * torch.sin(0.05 * u + 1.7) * torch.sin(0.11 * v + 0.3)
    b = 0.5 + 0.5 * torch.cos(0.09 * u - 0.5) * torch.cos(0.15 * v + 2.1)
    return torch.stack([r, g, b], -1).float()


def _surface(structure: str, x, y, base):
    """Heightfield z(x_world, y_world) of a structured scene."""
    if structure == "plane":
        return base.expand_as(x)
    if structure == "steps":
        z = base.expand_as(x)
        z = torch.where((x > -30) & (x < 10) & (y > -25) & (y < 5),
                        base - 25.0, z)
        return torch.where((x > 25) & (x < 60) & (y > -5) & (y < 30),
                           base - 45.0, z)
    if structure == "sphere":
        r2 = (x - 10.0) ** 2 + (y + 5.0) ** 2
        return base - torch.sqrt(torch.clamp(55.0 ** 2 - r2, min=0.0))
    if structure == "ridges":
        return base - 18.0 * torch.sin(x / 14.0) * torch.cos(y / 17.0)
    raise ValueError(f"unknown structure {structure}")


def _cameras(n, nviews, height, width, focal, baseline, device):
    k = torch.tensor([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0],
                      [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
    extr = torch.eye(4, dtype=torch.float32, device=device).repeat(nviews, 1, 1)
    extr[:, 0, 3] = -baseline * torch.arange(nviews, dtype=torch.float32,
                                             device=device)
    return (k.expand(n, nviews, 3, 3).contiguous(),
            extr.expand(n, nviews, 4, 4).contiguous())


def _rays(height, width, focal, device):
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=device),
        torch.arange(width, dtype=torch.float64, device=device),
        indexing="ij")
    return (xs - width / 2.0) / focal, (ys - height / 2.0) / focal


def draw(seed: int, n: int) -> dict:
    """Each scene's parameters from ``seed``. The set is stratified, so
    that every seed makes nearly the same set of scenes in another order:
    base depths and tilts one in each of ``n`` equal bins of their ranges,
    each structure ``n / 4`` times; the texture offset is free."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(n, 3, generator=gen, dtype=torch.float64)
    bins = [torch.randperm(n, generator=gen).double() for _ in range(3)]
    span = BASE[1] - BASE[0]
    return {"base": BASE[0] + span * (bins[0] + u[:, 0]) / n,
            "shift": span * ((bins[0] + 0.5) / n - 0.5),
            "tilt": -0.08 + 0.16 * (bins[1] + u[:, 1]) / n,
            "offset": 400.0 * u[:, 2],
            "structure": [STRUCTURES[int(k) % len(STRUCTURES)]
                          for k in bins[2]]}


def plane_scenes(seed: int, n: int, nviews: int, height: int, width: int, *,
                 focal: float, baseline: float, device,
                 range_follows_depth: bool = False) -> dict:
    """``n`` views of textured tilted planes z = base + tilt * x_world
    (``make_plane_scene``): every pixel of every view sees the plane."""
    p = draw(seed, n)
    dx, dy = _rays(height, width, focal, device)
    base = p["base"].to(device).reshape(n, 1, 1, 1)
    tilt = p["tilt"].to(device).reshape(n, 1, 1, 1)
    cx = baseline * torch.arange(nviews, dtype=torch.float64,
                                 device=device).reshape(1, nviews, 1, 1)
    z = (base + tilt * cx) / (1.0 - tilt * dx)
    off = p["offset"].to(device).reshape(n, 1, 1, 1)
    imgs = _texture((cx + z * dx) * 4.0 + off, z * dy * 4.0 + off)
    return _scene(imgs, z, p["shift"] if range_follows_depth else None,
                  nviews, height, width, focal, baseline, device)


def structured_scenes(seed: int, n: int, nviews: int, height: int,
                      width: int, *, focal: float, baseline: float,
                      device, range_follows_depth: bool = False) -> dict:
    """``n`` views of textured heightfields (steps, a dome, ridges or a
    plane) rendered by ray marching with occlusion
    (``make_structured_scene``): depth discontinuities and curved relief."""
    p = draw(seed, n)
    dx, dy = _rays(height, width, focal, device)
    cx = baseline * torch.arange(nviews, dtype=torch.float64,
                                 device=device).reshape(nviews, 1, 1)
    depths = []
    for i in range(n):
        base = p["base"][i].to(device)
        z_lo, z_hi = float(base) - 70.0, float(base) + 10.0
        h_prev = torch.full((nviews, height, width), -1.0,
                            dtype=torch.float64, device=device)
        z_hit = torch.full_like(h_prev, math.nan)
        z_prev = z_lo
        for z in torch.linspace(z_lo, z_hi, N_MARCH).tolist():
            h = z - _surface(p["structure"][i], cx + z * dx, z * dy, base)
            cross = torch.isnan(z_hit) & (h >= 0.0) & (h_prev < 0.0)
            denom = torch.where(h - h_prev > 1e-12, h - h_prev, 1.0)
            frac = torch.clamp(-h_prev / denom, 0.0, 1.0)
            z_hit = torch.where(cross, z_prev + frac * (z - z_prev), z_hit)
            h_prev, z_prev = h, z
        depths.append(torch.where(torch.isnan(z_hit), z_hi, z_hit))
    z = torch.stack(depths)
    off = p["offset"].to(device).reshape(n, 1, 1, 1)
    imgs = _texture((cx + z * dx) * 4.0 + off, z * dy * 4.0 + off)
    return _scene(imgs, z, p["shift"] if range_follows_depth else None,
                  nviews, height, width, focal, baseline, device)


def _scene(imgs, z, shift, nviews, height, width, focal, baseline, device):
    n = z.shape[0]
    intr, extr = _cameras(n, nviews, height, width, focal, baseline, device)
    rng = torch.tensor(DEPTH_RANGE, dtype=torch.float64).repeat(n, 1)
    if shift is not None:
        rng = rng + shift.reshape(n, 1)
    return {"imgs": imgs.contiguous(), "extrinsics": extr, "intrinsics": intr,
            "depth_range": rng.float().to(device),
            "depth": z[:, 0].float().contiguous()}


GENERATORS = {"plane": plane_scenes, "structured": structured_scenes}


def pyramid(depth: torch.Tensor) -> dict:
    """The 4-level ground-truth pyramid by nearest subsampling, as the
    port's loaders build it: {"3": 1/8, "2": 1/4, "1": 1/2, "0": full}."""
    return {str(k): depth[..., ::2 ** k, ::2 ** k].contiguous()
            for k in range(4)}
