"""Fusion A: dynamic multi-view consistency filter (the main method for
Tanks & Temples); the port of ``mdfnet_tpu/fusion/dynamic_filter.py``.

Every source view is reprojected in one batched pass over (S, H, W), and
the nine dynamic thresholds are one comparison against the ladder

    dist < i/thre1  AND  |d_reproj - d_ref|/d_ref < i/thre2,  i in [2, 10]

whose per-rung counts accumulate over sources; a pixel passes geometrically
when sum_i [count_i >= i] >= nconditions, photometrically when its
confidence > photo_thresh. Accepted pixels are averaged over agreeing views
and back-projected to a colored world-space point cloud.

The projections are elementwise f32 with explicit FMAs
(``geometry.matmul``), so the masks are the same bits on the card and on the
CPU, whatever TF32 setting is in force.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.data.formats import (
    ensure_dir, read_cam_file, read_image, read_pair_file, read_pfm,
    write_mask_png, write_pfm)
from mdfnet_tpu_torch.fusion.pairs import _find_pair_file
from mdfnet_tpu_torch.fusion.ply import write_ply
from mdfnet_tpu_torch.models.registry import resolve_device
from mdfnet_tpu_torch.ops.sample import bilinear_sample_2d

THRESHOLD_STEPS = tuple(range(2, 11))  # the 9-rung dynamic ladder


def _reproject(ref_depth, ref_k, ref_e, src_depths, src_ks, src_es):
    """Ref depth (H, W) into each source (S, H, W), the source depth
    resampled there, lifted and projected back: (d, x, y), each (S, H, W),
    in the ref frame."""
    s, (h, w) = src_depths.shape[0], ref_depth.shape
    world = geometry.unproject(ref_depth[None], ref_k[None], ref_e[None])
    x_src, y_src, _ = geometry.project(world.expand(s, 3, h * w), src_ks,
                                       src_es)
    # bilinear resample of the src depth at the projected coords (the
    # reference samples with align_corners=True on pixel coords == plain
    # pixel-space bilinear, tools/filter/data_io.py:117-131)
    sampled = bilinear_sample_2d(src_depths[..., None], x_src, y_src,
                                 fused=True)[..., 0]
    # lift the *projected* src pixel at the sampled depth, then back to ref
    ones = torch.ones_like(x_src)
    cam = geometry.matmul(geometry.inverse(src_ks),
                          torch.stack([x_src, y_src, ones], 1))
    cam_h = torch.cat([cam * sampled[:, None], ones[:, None]], 1)
    world = geometry.matmul(geometry.inverse(src_es), cam_h)[:, :3]
    x_ref, y_ref, d_ref = geometry.project(
        world, ref_k.expand(s, 3, 3), ref_e.expand(s, 4, 4))
    return (d_ref.reshape(s, h, w), x_ref.reshape(s, h, w),
            y_ref.reshape(s, h, w))


def reproject_depth(ref_depth, ref_k, ref_e, src_depth, src_k, src_e):
    """Project ref depth into src, resample src depth, project back.

    Twin of reference reproject_with_depth (dynamic_filter_gpu.py:194-238).
    All maps (H, W); cams (3,3)/(4,4). Returns (depth_reprojected, x_reproj,
    y_reproj) in the ref frame.
    """
    d, x, y = _reproject(ref_depth, ref_k, ref_e, src_depth[None],
                         src_k[None], src_e[None])
    return d[0], x[0], y[0]


def _tensors(device, *arrays):
    """numpy arrays (or None) as tensors on ``device``: the host boundary
    of the per-view functions."""
    return [None if a is None else
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _sum_sources(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (source) axis in source order, as the JAX
    package's reduction adds them, on every device alike."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def geometric_consistency(ref_depth, ref_k, ref_e, src_depths, src_ks, src_es,
                          src_valid=None,
                          thre1: float = 4.0, thre2: float = 1300.0):
    """All-src geometric consistency in one batched pass, on the inputs'
    device.

    Args:
        ref_depth: (H, W); src_depths: (S, H, W); cams batched likewise.
        src_valid: optional (S,) bool — padded sources contribute nothing.
    Returns:
        counts: (9, H, W) int32 — per-rung agreement counts over srcs.
        strict_mask_sum: (H, W) int32 — count of srcs passing the strictest
            final rung (i=10; the reference's `mask`, used for averaging).
        depth_sum: (H, W) f32 — sum of reprojected depths over srcs passing
            the final rung (zeros elsewhere), for view-averaged depth.
    """
    h, w = ref_depth.shape
    d_re, x_re, y_re = _reproject(ref_depth, ref_k, ref_e, src_depths,
                                  src_ks, src_es)
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=ref_depth.device),
        torch.arange(w, dtype=torch.float32, device=ref_depth.device),
        indexing="ij")
    dx, dy = x_re - xx, y_re - yy
    dist = torch.sqrt(geometry.fma(dx, dx, dy * dy))
    rel = (d_re - ref_depth).abs() / ref_depth
    steps = torch.tensor(THRESHOLD_STEPS, dtype=torch.float32,
                         device=ref_depth.device)[:, None, None, None]
    masks = (dist < steps / thre1) & (rel < steps / thre2)   # (9, S, H, W)
    if src_valid is not None:
        masks = masks & src_valid.to(masks.device)[:, None, None]
    final = masks[-1]
    depths = torch.where(final, d_re, torch.zeros_like(d_re))
    return (masks.sum(1, dtype=torch.int32), final.sum(0, dtype=torch.int32),
            _sum_sources(depths))


def fuse_view(ref_depth: np.ndarray, confidence: np.ndarray,
              ref_k: np.ndarray, ref_e: np.ndarray,
              src_depths: np.ndarray, src_ks: np.ndarray, src_es: np.ndarray,
              photo_thresh: float = 0.8, nconditions: int = 5,
              thre1: float = 4.0, thre2: float = 1300.0,
              src_valid: np.ndarray | None = None,
              device: str | torch.device = "cuda"):
    """One ref view's filtered depth + masks (all numpy in/out), computed
    on ``device`` (the card unless the caller asks for the CPU)."""
    counts, strict_sum, depth_sum = (x.cpu().numpy() for x in
                                     geometric_consistency(
        *_tensors(resolve_device(device), ref_depth, ref_k, ref_e,
                  src_depths, src_ks, src_es, src_valid),
        thre1=float(thre1), thre2=float(thre2)))

    rungs_passed = (counts >= np.asarray(THRESHOLD_STEPS)[:, None, None]).sum(0)
    geo_mask = rungs_passed >= nconditions
    photo_mask = confidence > photo_thresh
    final_mask = geo_mask & photo_mask
    depth_avg = (depth_sum + ref_depth) / (strict_sum + 1)
    return depth_avg, geo_mask, photo_mask, final_mask


def fuse_scan(scan_dir: str, eval_dir: str, out_ply: str,
              img_folder: str = "images", cam_folder: str = "cams",
              photo_thresh: float = 0.8, nconditions: int = 5,
              thre1: float = 4.0, thre2: float = 1300.0,
              filter_folder: Optional[str] = None,
              log_fn=print, device: str | torch.device = "cuda") -> np.ndarray:
    """Fuse a whole scan into a point cloud .ply.

    Twin of reference filter() (dynamic_filter_gpu.py:12-164). Reads the
    scan's pair.txt + cams + images from `scan_dir` and depth_est/confidence
    PFMs from `eval_dir`; writes masks + filtered depth (if filter_folder)
    and the fused cloud to `out_ply`.
    """
    from mdfnet_tpu_torch.fusion.view_store import ViewStore, pad_sources

    device = resolve_device(device)
    _, pairs = read_pair_file(_find_pair_file(scan_dir))
    if filter_folder:
        ensure_dir(filter_folder)
    max_s = max(len(srcs) for _, srcs in pairs)

    def load_view(vid):
        k, e, _ = read_cam_file(os.path.join(
            scan_dir, cam_folder, f"{vid:08d}_cam.txt"))
        return {"depth": read_pfm(os.path.join(
                    eval_dir, "depth_est", f"{vid:08d}.pfm"))[0],
                "k": k, "e": e}

    verts: List[np.ndarray] = []
    colors: List[np.ndarray] = []
    with ViewStore(load_view, maxsize=4 * max_s) as store:
        for ref_view, src_views in pairs:
            t0 = time.time()
            rv = store.get(ref_view)
            ref_depth, ref_k, ref_e = rv["depth"], rv["k"], rv["e"]
            confidence = read_pfm(os.path.join(
                eval_dir, "confidence", f"{ref_view:08d}.pfm"))[0]
            ref_img = read_image(os.path.join(
                scan_dir, img_folder, f"{ref_view:08d}.jpg"))

            svs = [store.get(sv) for sv in src_views]
            (src_depths, src_ks, src_es), src_valid = pad_sources(
                [np.stack([v["depth"] for v in svs]),
                 np.stack([v["k"] for v in svs]),
                 np.stack([v["e"] for v in svs])], max_s)

            depth_avg, geo_mask, photo_mask, final_mask = fuse_view(
                ref_depth, confidence, ref_k, ref_e,
                src_depths, src_ks, src_es,
                photo_thresh, nconditions, thre1, thre2, src_valid=src_valid,
                device=device)

            if filter_folder:
                for name, mask in (("photo", photo_mask), ("geo", geo_mask),
                                   ("final", final_mask)):
                    write_mask_png(os.path.join(
                        filter_folder, f"{ref_view:08d}_{name}.png"), mask)
                write_pfm(os.path.join(filter_folder,
                                       f"{ref_view}_depth_est.pfm"),
                          (ref_depth * final_mask).astype(np.float32))

            h, w = depth_avg.shape
            ys, xs = np.nonzero(final_mask)
            if len(ys):
                d = depth_avg[ys, xs]
                pix = np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64)
                cam = np.linalg.inv(ref_k) @ (pix * d)
                world = np.linalg.inv(ref_e) @ np.vstack(
                    [cam, np.ones_like(d)])
                verts.append(world[:3].T.astype(np.float32))
                colors.append((ref_img[:h, :w][ys, xs] * 255)
                              .astype(np.uint8))

            if log_fn:
                log_fn(f"view {ref_view:>3}: photo/geo/final = "
                       f"{photo_mask.sum()}/{geo_mask.sum()}/"
                       f"{final_mask.sum()}  ({time.time()-t0:.2f}s)")

    xyz = np.concatenate(verts, axis=0) if verts else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(colors, axis=0) if colors else np.zeros((0, 3), np.uint8)
    ensure_dir(os.path.dirname(out_ply) or ".")
    write_ply(out_ply, xyz, rgb)
    if log_fn:
        log_fn(f"saved {len(xyz)} points -> {out_ply}")
    return xyz
