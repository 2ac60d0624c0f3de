"""Fusion B: fusibile-style per-pixel multi-view consistency vote; the port
of ``mdfnet_tpu/fusion/consistency_vote.py``.

For every ref pixel with (prob-filtered) depth d:
  1. back-project to world X;
  2. for each other view: project X -> (x_s, y_s) and depth-in-src d_X;
     bilinear-sample the src depth map at (x_s, y_s) -> d_s;
  3. consistent when |f_ref*B/d_X - f_ref*B/d_s| < disp_thresh with
     B = ||C_ref - C_src|| (disparity-space threshold, reference
     fusibile.cu:41-53, 206-210); the reference's normal-angle test is
     vacuous (its gipuma front end fakes constant normals) and is omitted;
  4. average the world points back-projected from each agreeing src at its
     *truncated* integer pixel with its sampled depth (fusibile.cu:233-241),
     plus the ref point, over (n_consistent + 1);
  5. emit when n_consistent >= num_consistent (default 3, reference
     gipuma/conf.py:34-36).

All sources go in one batched pass over (S, H*W) on the inputs' device, with
the projections in elementwise f32 and explicit FMAs (``geometry.matmul``):
the card's votes are the CPU's bits.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.data.formats import (
    ensure_dir, read_cam_file, read_image, read_pair_file, read_pfm)
from mdfnet_tpu_torch.fusion.dynamic_filter import _sum_sources, _tensors
from mdfnet_tpu_torch.fusion.pairs import _find_pair_file
from mdfnet_tpu_torch.fusion.ply import write_ply
from mdfnet_tpu_torch.models.registry import resolve_device
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d


def _center(e: torch.Tensor) -> torch.Tensor:
    """Camera centers C = -R^T t of extrinsics (..., 4, 4): (..., 3)."""
    rot_t = -e[..., :3, :3].transpose(-1, -2)
    return geometry.matmul(rot_t, e[..., :3, 3:])[..., 0]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (3), its squares summed in order
    with FMAs, as the JAX package's CPU backend sums them."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = geometry.fma(v[..., i], v[..., i], acc)
    return torch.sqrt(acc)


def consistency_vote(ref_depth, ref_k, ref_e, src_depths, src_ks, src_es,
                     src_valid=None,
                     disp_thresh: float = 0.25, num_consistent: int = 3):
    """One ref view's vote against all srcs, on the inputs' device.

    Args:
        ref_depth: (H, W) prob-filtered depth (0 = invalid).
        src_depths: (S, H, W); cams batched likewise.
        src_valid: optional (S,) bool mask for padded sources.
    Returns:
        points: (H*W, 3) averaged world points;
        accept: (H*W,) bool — n_consistent >= num_consistent and ref valid.
    """
    s, (h, w) = src_depths.shape[0], ref_depth.shape
    n = h * w
    f_ref = ref_k[0, 0]
    x_world = geometry.unproject(ref_depth[None], ref_k[None], ref_e[None])

    x_s, y_s, d_x = geometry.project(x_world.expand(s, 3, n), src_ks, src_es)
    in_bounds = (x_s >= 0) & (x_s < w) & (y_s >= 0) & (y_s < h)
    d_s = bilinear_sample_2d(src_depths[..., None], x_s, y_s,
                             fused=True)[..., 0]
    baseline = _norm(_center(ref_e)[None] - _center(src_es))     # (S,)
    fb = (f_ref * baseline)[:, None]
    ok = (in_bounds & ((fb / d_x - fb / d_s).abs() < disp_thresh)
          & (d_s > 0))

    # back-project the *truncated* src pixel at the sampled depth
    ones = torch.ones_like(x_s)
    pix = torch.stack([torch.floor(x_s), torch.floor(y_s), ones], 1)
    cam = geometry.matmul(geometry.inverse(src_ks), pix) * d_s[:, None]
    world_s = geometry.matmul(geometry.inverse(src_es),
                              torch.cat([cam, ones[:, None]], 1))[:, :3]
    if src_valid is not None:
        ok = ok & src_valid.to(ok.device)[:, None]
    worlds = torch.where(ok[:, None], world_s, torch.zeros_like(world_s))
    n_consistent = ok.sum(0, dtype=torch.int32)
    avg = (x_world[0] + _sum_sources(worlds)) / (n_consistent + 1).float()
    accept = (n_consistent >= num_consistent) & (ref_depth.reshape(-1) > 0)
    return avg.T, accept


def fuse_scan_vote(scan_dir: str, eval_dir: str, out_ply: str,
                   img_folder: str = "images", cam_folder: str = "cams",
                   prob_thresh: float = 0.6, disp_thresh: float = 0.25,
                   num_consistent: int = 3, log_fn=print,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Fuse a scan with the consistency vote (every view acts as ref once,
    like fusibile's host loop over cameras, main.cpp:787-800), on
    ``device`` (the card unless the caller asks for the CPU)."""
    from mdfnet_tpu_torch.fusion.view_store import ViewStore, pad_sources

    device = resolve_device(device)
    _, pairs = read_pair_file(_find_pair_file(scan_dir))
    view_ids = [ref for ref, _ in pairs]
    id_set = set(view_ids)
    max_s = max(len([s for s in srcs if s in id_set]) for _, srcs in pairs)

    def load_view(vid):
        d = read_pfm(os.path.join(eval_dir, "depth_est", f"{vid:08d}.pfm"))[0]
        conf = read_pfm(os.path.join(eval_dir, "confidence",
                                     f"{vid:08d}.pfm"))[0]
        k, e, _ = read_cam_file(os.path.join(scan_dir, cam_folder,
                                             f"{vid:08d}_cam.txt"))
        return {"depth": np.where(conf >= prob_thresh, d, 0.0)
                .astype(np.float32), "k": k, "e": e}

    verts: List[np.ndarray] = []
    colors: List[np.ndarray] = []
    with ViewStore(load_view, maxsize=4 * max_s) as store:
        for ref, srcs in pairs:
            src_ids = [s for s in srcs if s in id_set]
            rv = store.get(ref)
            svs = [store.get(s) for s in src_ids]
            (sd, sk, se), src_valid = pad_sources(
                [np.stack([v["depth"] for v in svs]),
                 np.stack([v["k"] for v in svs]),
                 np.stack([v["e"] for v in svs])], max_s)
            pts, accept = consistency_vote(
                *_tensors(device, rv["depth"], rv["k"], rv["e"], sd, sk, se,
                          src_valid), disp_thresh=float(disp_thresh),
                num_consistent=int(num_consistent))
            pts = pts.cpu().numpy()
            accept = accept.cpu().numpy()
            h, w = rv["depth"].shape
            if accept.any():
                # the ref image is used exactly once — loaded on demand as
                # uint8-scaled colors, never resident for the whole scan
                img = read_image(os.path.join(scan_dir, img_folder,
                                              f"{ref:08d}.jpg"))
                verts.append(pts[accept].astype(np.float32))
                colors.append((img[:h, :w].reshape(-1, 3)[accept] * 255)
                              .astype(np.uint8))
            if log_fn:
                log_fn(f"view {ref:>3}: {int(accept.sum())} points")

    xyz = np.concatenate(verts, axis=0) if verts else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(colors, axis=0) if colors else np.zeros((0, 3), np.uint8)
    ensure_dir(os.path.dirname(out_ply) or ".")
    write_ply(out_ply, xyz, rgb)
    if log_fn:
        log_fn(f"saved {len(xyz)} points -> {out_ply}")
    return xyz
