"""Fusion C: pcd-style visibility fusion; the port of
``mdfnet_tpu/fusion/pcd_fusion.py``.

Behavioural twin of reference tools/pcd/fusion.py: probability filter ->
visibility filter -> occlusion-aware z-buffer fusion -> visibility filter ->
view-averaged depth -> visibility filter -> small-segment removal ->
back-projection to a world point cloud.

The projection, resampling and violation counting run on the inputs'
device over full (S, H, W) grids (masks instead of the reference's dynamic
valid-pixel flattening), in elementwise f32 with explicit FMAs
(``geometry.fma``): the card's candidates, counts and masks are the CPU's
bits. The two sequential cores (per-pixel z-buffer election, component flood
fill) run on the host in the native C library (``fusion/native.py``).

Convention note: this pipeline treats pixel centers at (+0.5, +0.5) like the
reference pcd tool (tools/pcd/utils/utils.py:get_pixel_grids), which differs
by half a pixel from the model/filter tools — preserved for parity.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from mdfnet_tpu_torch import geometry
from mdfnet_tpu_torch.data.formats import (
    ensure_dir, read_cam_file, read_image, read_pair_file, read_pfm)
from mdfnet_tpu_torch.fusion.dynamic_filter import _sum_sources, _tensors
from mdfnet_tpu_torch.fusion.native import segment_filter, zbuffer_elect
from mdfnet_tpu_torch.fusion.pairs import _find_pair_file
from mdfnet_tpu_torch.fusion.ply import write_ply
from mdfnet_tpu_torch.models.registry import resolve_device


def _centers(h: int, w: int, device=None) -> torch.Tensor:
    """Pixel-center homogeneous grid (3, H*W), +0.5 convention."""
    grid = geometry.pixel_grid(h, w, device=device)
    return torch.cat([grid[:2] + 0.5, grid[2:]])


def _img2world(pix, depth_flat, k, e):
    """(..., 3, N) center pixels at depths (..., N) -> (..., 3, N) world
    through K (..., 3, 3), E (..., 4, 4). Zero depth -> the camera center."""
    cam = geometry.matmul(geometry.inverse(k), pix) * depth_flat[..., None, :]
    ones = torch.ones_like(cam[..., :1, :])
    return geometry.matmul(geometry.inverse(e),
                           torch.cat([cam, ones], -2))[..., :3, :]


def _world2img(world, k, e):
    """(..., 3, N) world -> (x, y center-conv, depth), each (..., N)."""
    ones = torch.ones_like(world[..., :1, :])
    cam = geometry.matmul(e, torch.cat([world, ones], -2))[..., :3, :]
    pix = geometry.matmul(k, cam)
    z = cam[..., 2, :]
    return pix[..., 0, :] / z, pix[..., 1, :] / z, z


def _cell(x: torch.Tensor) -> torch.Tensor:
    """round(x - 0.5), halves to even, as an integer the way the JAX
    package converts it: saturating, NaN to 0 (int64, so no value wraps)."""
    r = torch.round(x - 0.5)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return r.clamp(-2.0 ** 31, 2.0 ** 31).long()


def _nearest_sample(depth_map, x, y):
    """Nearest sampling in center convention: cell = round(x - 0.5).
    ``depth_map`` (..., H, W), ``x``, ``y`` (..., N)."""
    h, w = depth_map.shape[-2:]
    xi, yi = _cell(x), _cell(y)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    vals = torch.gather(depth_map.reshape(*depth_map.shape[:-2], h * w), -1,
                        idx)
    return torch.where(ok, vals, torch.zeros_like(vals)), ok


def reproject_all(ref_depth, ref_k, ref_e, src_depths, src_ks, src_es,
                  src_valid=None):
    """Ref->src->ref reprojection for every src, on the inputs' device.

    Returns (x, y, d, in_range): each (S, H, W); (x, y) center-convention ref
    coords of the reprojected point, d its depth in the ref camera; in_range
    marks samples that landed inside the src image on valid src depth
    (twin of reference get_reproj, tools/pcd/fusion.py:29-54).
    """
    s, (h, w) = src_depths.shape[0], ref_depth.shape
    d_flat = ref_depth.reshape(-1)
    world = _img2world(_centers(h, w, ref_depth.device), d_flat, ref_k, ref_e)
    xs, ys, _ = _world2img(world.expand(s, 3, h * w), src_ks, src_es)
    d_s, in_img = _nearest_sample(src_depths, xs, ys)
    ok = in_img & (d_s > 1e-9)
    src_pix = torch.stack([xs, ys, torch.ones_like(xs)], 1)
    w_back = _img2world(src_pix, d_s, src_ks, src_es)
    xr, yr, dr = _world2img(w_back, ref_k.expand(s, 3, 3),
                            ref_e.expand(s, 4, 4))
    rng = ok & (d_flat > 1e-9)
    if src_valid is not None:
        rng = rng & src_valid.to(rng.device)[:, None]
    return (xr.reshape(s, h, w), yr.reshape(s, h, w), dr.reshape(s, h, w),
            rng.reshape(s, h, w))


def visibility_masks(ref_depth, xr, yr, dr, in_range,
                     dist_thresh: float = 1.0, rel_thresh: float = 0.01,
                     vthresh: int = 4):
    """Per-src agreement masks + the >= (vthresh-1) vote
    (twin of reference vis_filter, tools/pcd/fusion.py:56-63)."""
    h, w = ref_depth.shape
    dev = ref_depth.device
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    dx, dy = xr - xx, yr - yy
    dist = torch.sqrt(geometry.fma(dx, dx, dy * dy))
    depth_ok = ((ref_depth - dr).abs()
                < torch.maximum(ref_depth.expand_as(dr), dr) * rel_thresh)
    masks = in_range & (dist < dist_thresh) & depth_ok
    mask = masks.sum(0) >= (vthresh - 1)
    return masks, mask


def averaged_depth(ref_depth, dr, masks):
    """View-averaged depth over agreeing srcs (reference ave_fusion)."""
    s = _sum_sources(torch.where(masks, dr, torch.zeros_like(dr)))
    return (s + ref_depth) / (masks.sum(0, dtype=torch.int32) + 1).float()


def _candidates_and_violations(ref_depth, ref_k, ref_e,
                               src_depths, src_ks, src_es, src_valid=None):
    """Build the z-buffer candidate set for one ref view, on the inputs'
    device.

    Candidates = ref's own pixels + every src pixel projected into ref
    ((1+S)*H*W entries). For each candidate, count violations: srcs whose
    measured depth at the candidate's projection exceeds the candidate's
    depth there (it would occlude what that src actually sees) — twin of
    reference vis_fusion (tools/pcd/fusion.py:69-98). The counts add one
    source at a time (:func:`_violations`), so no (S, M) array is held.

    Returns (xy (M,2) ref center coords, d (M,) ref-frame depth,
    violation (M,) int32, cand_valid (M,) bool).
    """
    s, h, w = src_depths.shape
    pix = _centers(h, w, ref_depth.device)

    # src pixels -> ref
    src_flat = src_depths.reshape(s, -1)
    world = _img2world(pix.expand(s, 3, h * w), src_flat, src_ks, src_es)
    xs, ys, ds = _world2img(world, ref_k.expand(s, 3, 3),
                            ref_e.expand(s, 4, 4))
    vs = src_flat > 1e-9
    if src_valid is not None:
        vs = vs & src_valid.to(vs.device)[:, None]
    ref_flat = ref_depth.reshape(-1)
    x_all = torch.cat([pix[0][None], xs], 0).reshape(-1)
    y_all = torch.cat([pix[1][None], ys], 0).reshape(-1)
    d_all = torch.cat([ref_flat[None], ds], 0).reshape(-1)
    valid = torch.cat([(ref_flat > 1e-9)[None], vs], 0).reshape(-1)
    del world, xs, ys, ds
    vio = _violations(x_all, y_all, d_all, ref_k, ref_e, src_depths, src_ks,
                      src_es, src_valid)
    return torch.stack([x_all, y_all], 1), d_all, vio, valid


def _violations(x, y, d, ref_k, ref_e, src_depths, src_ks, src_es,
                src_valid=None) -> torch.Tensor:
    """Violation counts (M,) int32 of candidates at ref center coords
    (x, y) and ref-frame depths d, each (M,): each is independent of the
    others, so any subset of the candidates gives its own counts."""
    # re-lift candidates through the REF camera at their ref-frame depth
    # (the reference re-lifts via idx_img2world on the ref cam, :90)
    world = _img2world(torch.stack([x, y, torch.ones_like(x)], 0), d,
                       ref_k, ref_e)
    valid = (np.ones(len(src_depths), bool) if src_valid is None
             else src_valid.cpu().numpy())
    vio = torch.zeros_like(d, dtype=torch.int32)
    for i in np.flatnonzero(valid):
        xs, ys, dz = _world2img(world, src_ks[i], src_es[i])
        d_s, _ = _nearest_sample(src_depths[i], xs, ys)
        vio += d_s > dz
    return vio


def zbuffer_fusion(ref_depth: np.ndarray, ref_k, ref_e,
                   src_depths: np.ndarray, src_ks, src_es,
                   src_valid=None, device: str | torch.device = "cuda",
                   times: dict | None = None) -> np.ndarray:
    """Occlusion-aware fused depth for one ref view: the candidates and
    their violation counts on ``device`` (the card unless the caller asks
    for the CPU), the election in the native library on the host.
    ``times``, where given, adds up the seconds of each part: the
    candidates, their copy to the host, the election."""
    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    xy, d, vio, valid = _candidates_and_violations(*_tensors(
        device, ref_depth, ref_k, ref_e, src_depths, src_ks, src_es,
        src_valid))
    d = torch.where(valid, d, torch.zeros_like(d))
    sync()
    t1 = time.perf_counter()
    xy, d, vio = xy.cpu().numpy(), d.cpu().numpy(), vio.cpu().numpy()
    t2 = time.perf_counter()
    out = zbuffer_elect(d, xy, vio, ref_depth > 1e-9)
    if times is not None:
        for key, sec in (("candidates", t1 - t0), ("copy", t2 - t1),
                         ("election", time.perf_counter() - t2)):
            times[key] = times.get(key, 0.0) + sec
    return out


def _normals_from_depth(depth: np.ndarray, k: np.ndarray, e: np.ndarray,
                        device: str | torch.device = "cpu") -> np.ndarray:
    """Per-pixel normals from depth-map gradients, oriented to the camera.

    Documented deviation: the reference estimates normals with open3d kNN-PCA
    over the fused cloud (tools/pcd/fusion.py:248-254); depth-gradient normals
    are equivalent for benchmark use. The back-projection runs on
    ``device``, the rest in numpy.
    """
    h, w = depth.shape
    world = _img2world(_centers(h, w, device),
                       *_tensors(device, depth.reshape(-1), k, e)
                       ).cpu().numpy()
    pts = world.T.reshape(h, w, 3)
    dx = np.gradient(pts, axis=1)
    dy = np.gradient(pts, axis=0)
    n = np.cross(dx.reshape(-1, 3), dy.reshape(-1, 3))
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    center = -e[:3, :3].T @ e[:3, 3]
    to_cam = center[None] - pts.reshape(-1, 3)
    flip = (n * to_cam).sum(1, keepdims=True) < 0
    return np.where(flip, -n, n).astype(np.float32)


def fuse_scan_pcd(scan_dir: str, eval_dir: str, out_ply: str,
                  img_folder: str = "images", cam_folder: str = "cams",
                  prob_thresh: float = 0.8, nviews: int = 10, vthresh: int = 4,
                  seg_window: int = 4, seg_diff: float = 1e-3,
                  seg_size: int = 10, with_normals: bool = True,
                  log_fn=print, device: str | torch.device = "cuda",
                  times: dict | None = None) -> np.ndarray:
    """Full pcd pipeline over a scan (twin of reference get_cloud), the
    per-view passes on ``device`` (the card unless the caller asks for the
    CPU).

    Memory-lean: per-view arrays live in a disk-spilling LRU ViewStore
    (bounded host RSS at Tanks scale — the reference chunks its candidate
    sets similarly, tools/pcd/fusion.py:88-97), images are loaded lazily at
    the final color step only. ``times``, where given, adds up the scan's
    seconds by part: the z-buffer's candidates, their copy to the host, the
    native election and the segment filter.
    """
    from mdfnet_tpu_torch.fusion.view_store import ViewStore, pad_sources

    device = resolve_device(device)
    _, pairs = read_pair_file(_find_pair_file(scan_dir))
    view_ids = [r for r, _ in pairs]
    srcs_of = {r: [s for s in srcs if s in view_ids][:nviews]
               for r, srcs in pairs}
    max_s = max(len(v) for v in srcs_of.values())
    times = {} if times is None else times

    def load_view(vid):
        d = read_pfm(os.path.join(eval_dir, "depth_est", f"{vid:08d}.pfm"))[0]
        conf = read_pfm(os.path.join(eval_dir, "confidence",
                                     f"{vid:08d}.pfm"))[0]
        k, e, _ = read_cam_file(os.path.join(scan_dir, cam_folder,
                                             f"{vid:08d}_cam.txt"))
        mask = conf > prob_thresh
        return {"depth": (d * mask).astype(np.float32), "mask": mask,
                "k": k, "e": e}

    store = ViewStore(load_view, maxsize=4 * max_s)

    def gather(vid):
        rv = store.get(vid)
        svs = [store.get(s) for s in srcs_of[vid]]
        padded, valid = pad_sources(
            [np.stack([v["depth"] for v in svs]),
             np.stack([v["k"] for v in svs]),
             np.stack([v["e"] for v in svs])], max_s)
        return rv, padded, valid

    def reproject(vid):
        rv, (sd, sk, se), valid = gather(vid)
        depth, *rest = _tensors(device, rv["depth"], rv["k"], rv["e"], sd,
                                sk, se, valid)
        xr, yr, dr, rng = reproject_all(depth, *rest)
        masks, mask = visibility_masks(depth, xr, yr, dr, rng,
                                       vthresh=vthresh)
        return depth, dr, masks, mask

    def batch_vis_filter():
        # two sweeps (compute from OLD depths, then apply) with the interim
        # masks parked in the store so they spill with their views
        for vid in view_ids:
            store.update(vid, vnew=reproject(vid)[3].cpu().numpy())
        for vid in view_ids:
            v = store.get(vid)
            mask = v["mask"] & v["vnew"]
            store.update(vid, mask=mask, depth=v["depth"] * mask,
                         vnew=np.zeros((), np.uint8))

    try:
        batch_vis_filter()

        # z-buffer fusion
        for vid in view_ids:
            rv, (sd, sk, se), valid = gather(vid)
            fused = zbuffer_fusion(rv["depth"], rv["k"], rv["e"], sd, sk, se,
                                   src_valid=valid, device=device, times=times)
            store.update(vid, vnew=fused)
            if log_fn:
                log_fn(f"zbuffer {vid:>3}: {int((fused > 0).sum())} px")
        for vid in view_ids:
            v = store.get(vid)
            store.update(vid, depth=v["vnew"] * v["mask"],
                         vnew=np.zeros((), np.uint8))

        batch_vis_filter()

        # view-averaged depth
        for vid in view_ids:
            depth, dr, masks, _ = reproject(vid)
            store.update(vid, vnew=averaged_depth(depth, dr, masks)
                         .cpu().numpy())
        for vid in view_ids:
            v = store.get(vid)
            store.update(vid, depth=v["vnew"] * v["mask"],
                         vnew=np.zeros((), np.uint8))

        batch_vis_filter()

        # small segment removal
        t0 = time.perf_counter()
        for vid in view_ids:
            v = store.get(vid)
            seg_mask = segment_filter(v["depth"], seg_window, seg_diff,
                                      seg_size)
            mask = v["mask"] & seg_mask
            store.update(vid, mask=mask, depth=v["depth"] * mask)
        times["segment"] = times.get("segment", 0.0) + time.perf_counter() - t0

        # back-project (ref images loaded lazily, used once each)
        verts, colors, normals = [], [], []
        for vid in view_ids:
            v = store.get(vid)
            d = v["depth"]
            m = v["mask"] & (d > 1e-9)
            if not m.any():
                continue
            h, w = d.shape
            world = _img2world(_centers(h, w, device), *_tensors(
                device, d.reshape(-1), v["k"], v["e"])).cpu().numpy().T
            sel = m.reshape(-1)
            img = read_image(os.path.join(scan_dir, img_folder,
                                          f"{vid:08d}.jpg"))
            verts.append(world[sel].astype(np.float32))
            colors.append((img[:h, :w].reshape(-1, 3)[sel] * 255)
                          .astype(np.uint8))
            if with_normals:
                normals.append(_normals_from_depth(d, v["k"], v["e"],
                                                   device)[sel])
    finally:
        store.close()

    xyz = np.concatenate(verts, 0) if verts else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(colors, 0) if colors else np.zeros((0, 3), np.uint8)
    nrm = np.concatenate(normals, 0) if (normals and with_normals) else None
    ensure_dir(os.path.dirname(out_ply) or ".")
    write_ply(out_ply, xyz, rgb, nrm)
    if log_fn:
        log_fn(f"saved {len(xyz)} points -> {out_ply}")
    return xyz


def voxel_downsample(xyz: np.ndarray, rgb: np.ndarray | None = None,
                     normals: np.ndarray | None = None, voxel: float = 1.0):
    """Voxel-grid downsampling: one averaged point per occupied voxel.

    Replaces the reference's open3d voxel_down_sample option
    (tools/pcd/fusion.py:256-263).
    """
    if len(xyz) == 0:
        return xyz, rgb, normals
    keys = np.floor(xyz / voxel).astype(np.int64)
    # dense voxel hash via lexsort + group boundaries
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    k = keys[order]
    new_group = np.r_[True, (k[1:] != k[:-1]).any(1)]
    group_id = np.cumsum(new_group) - 1
    n_groups = group_id[-1] + 1

    def average(values):
        sums = np.zeros((n_groups, values.shape[1]), np.float64)
        np.add.at(sums, group_id, values[order])
        counts = np.bincount(group_id).astype(np.float64)
        return (sums / counts[:, None])

    out_xyz = average(xyz).astype(np.float32)
    out_rgb = (average(rgb).round().astype(np.uint8)
               if rgb is not None else None)
    out_nrm = None
    if normals is not None:
        n = average(normals)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        out_nrm = (n / np.maximum(norm, 1e-12)).astype(np.float32)
    return out_xyz, out_rgb, out_nrm
