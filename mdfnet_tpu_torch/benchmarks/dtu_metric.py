"""DTU Acc/Comp/Overall metric in Python (a copy of
``mdfnet_tpu/benchmarks/dtu_metric.py``; host code: numpy and a scipy
KD-tree).

Faithful reimplementation of the reference's MATLAB evaluation
(tools/matlab_linux/matlab2015/: BaseEvalMain_web.m, PointCompareMain.m,
MaxDistCP.m, reducePts_haa.m):

- the fused cloud is stochastically thinned to a 0.2 mm minimum spacing
  (reducePts_haa.m — random visit order, each kept point suppresses its
  neighbours);
- Acc  = mean/median nearest-neighbour distance data->GT over points inside
  the scan's ObsMask voxel grid, outliers >= 20 mm discarded;
- Comp = mean/median distance GT->data over GT points above the scan's
  ground plane, outliers >= 20 mm discarded;
- distances are computed with a KD-tree and capped at 60 mm
  (MaxDistCP.m's chunked search is an optimisation, not a semantic);
- Overall = (mean Acc + mean Comp) / 2, averaged over the 22 eval scans
  (BaseEvalMain_web.m:23,63,100).

Requires the official DTU SampleSet on disk (Points/stl plys + ObsMask/Plane
.mat files) — external data, loaded with scipy.io.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _csr_expand(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(group_id, within_group) indices enumerating sum(counts) slots."""
    total = int(counts.sum())
    gid = np.repeat(np.arange(len(counts)), counts)
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - np.repeat(cum, counts)
    return gid, within


def _neighbor_pairs(pts: np.ndarray, dst: float) -> Tuple[np.ndarray, np.ndarray]:
    """All directed pairs (i, j), i != j, with |pts[i]-pts[j]| < dst, via
    vectorised grid hashing (numpy only, no python-level point loops).

    Cells are matched at the unique-cell level (one binary search per
    OCCUPIED cell per half-space offset, directed pairs emitted both ways),
    then point pairs come from vectorised cross-products of the matched
    cells' point ranges."""
    n = len(pts)
    cell = np.floor(pts / dst).astype(np.int64)
    cell -= cell.min(axis=0)
    dims = cell.max(axis=0) + 2  # +2: room for +1 offsets without wrap
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]

    order = np.argsort(key, kind="stable")
    skey = key[order]
    ukey, ustart = np.unique(skey, return_index=True)
    ucount = np.diff(np.append(ustart, n))
    nu = len(ukey)

    # 13 half-space offsets (the other 13 come from emitting both
    # directions); offset 0 handled separately (within-cell pairs)
    half = [(ox, oy, oz)
            for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)
            if (ox, oy, oz) > (0, 0, 0)]

    dst2 = dst * dst
    srcs, dsts = [], []

    def emit(i_idx, j_idx, both_ways: bool):
        d = pts[i_idx] - pts[j_idx]
        ok = np.einsum("ij,ij->i", d, d) < dst2
        srcs.append(i_idx[ok])
        dsts.append(j_idx[ok])
        if both_ways:
            srcs.append(j_idx[ok])
            dsts.append(i_idx[ok])

    # within-cell: full directed cross product of each cell's points
    if nu and ucount.max() > 1:
        multi = np.flatnonzero(ucount > 1)
        cnts = ucount[multi]
        gid, t = _csr_expand(cnts * cnts)
        c_g = cnts[gid]
        a, b = t // c_g, t % c_g
        keep = a != b
        start = ustart[multi][gid[keep]]
        emit(order[start + a[keep]], order[start + b[keep]],
             both_ways=False)

    for off3 in half:
        off = (off3[0] * dims[1] + off3[1]) * dims[2] + off3[2]
        pos = np.searchsorted(ukey, ukey + off)
        pos = np.minimum(pos, nu - 1)
        hit = np.flatnonzero(ukey[pos] == ukey + off)
        if len(hit) == 0:
            continue
        a_cells = hit
        b_cells = pos[hit]
        na = ucount[a_cells]
        nb = ucount[b_cells]
        gid, t = _csr_expand(na * nb)
        nb_g = nb[gid]
        i_idx = order[ustart[a_cells][gid] + t // nb_g]
        j_idx = order[ustart[b_cells][gid] + t % nb_g]
        emit(i_idx, j_idx, both_ways=True)

    if not srcs:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return np.concatenate(srcs), np.concatenate(dsts)


def reduce_points(pts: np.ndarray, dst: float = 0.2,
                  seed: Optional[int] = 0) -> np.ndarray:
    """Stochastic thinning: keep a subset with pairwise spacing >= dst.

    Exact vectorised equivalent of reducePts_haa.m:1-35: points are visited
    in random order; each still-unsuppressed point is kept and suppresses
    every point within dst. That sequential greedy equals the
    rank-lexicographic maximal independent set of the dst-neighbourhood
    graph, computed here in parallel rounds (each round keeps every alive
    point whose rank is a local minimum among alive neighbours, then kills
    the winners' neighbours) — bit-identical keep set, O(log n) rounds,
    numpy throughout. ~10M points in seconds instead of hours.
    """
    n = len(pts)
    if n == 0:
        return pts
    rng = np.random.RandomState(seed)
    rank = np.empty(n, np.int64)
    rank[rng.permutation(n)] = np.arange(n)

    src, dst_idx = _neighbor_pairs(np.asarray(pts, np.float64), dst)

    alive = np.ones(n, bool)
    keep = np.zeros(n, bool)
    while alive.any():
        m = alive[src] & alive[dst_idx]
        nbr_min = np.full(n, n, np.int64)
        np.minimum.at(nbr_min, src[m], rank[dst_idx[m]])
        winners = alive & (rank < nbr_min)
        keep |= winners
        killed = np.zeros(n, bool)
        wm = winners[src]
        killed[dst_idx[wm]] = True
        alive &= ~(killed | winners)
        # drop settled pairs to shrink later rounds
        still = alive[src] | alive[dst_idx]
        src, dst_idx = src[still], dst_idx[still]
    return pts[keep]


def nn_distances(query: np.ndarray, target: np.ndarray,
                 max_dist: float = 60.0) -> np.ndarray:
    """Nearest-neighbour distance from each query point into target, capped
    at max_dist (PointCompareMain.m MaxDist=60)."""
    if len(target) == 0:
        return np.full(len(query), max_dist, np.float64)
    from scipy.spatial import cKDTree
    tree = cKDTree(target)
    d, _ = tree.query(query, k=1, distance_upper_bound=max_dist)
    return np.minimum(d, max_dist)


def _mask_lookup(pts: np.ndarray, obs_mask: np.ndarray, bb: np.ndarray,
                 res: float) -> np.ndarray:
    """ObsMask voxel test: Qv = round((p - BB_low)/Res + 1), 1-indexed
    (PointCompareMain.m:36-46)."""
    qv = np.round((pts - bb[0][None]) / res + 1).astype(np.int64)
    inside = ((qv > 0) & (qv <= np.asarray(obs_mask.shape)[None])).all(1)
    out = np.zeros(len(pts), bool)
    idx = qv[inside] - 1
    out[inside] = obs_mask[idx[:, 0], idx[:, 1], idx[:, 2]] > 0
    return out


def evaluate_scan(data_pts: np.ndarray, stl_pts: np.ndarray,
                  obs_mask: Optional[np.ndarray] = None,
                  bb: Optional[np.ndarray] = None, res: float = 1.0,
                  plane: Optional[np.ndarray] = None,
                  dst: float = 0.2, max_dist: float = 60.0,
                  outlier: float = 20.0, seed: int = 0) -> Dict[str, float]:
    """Acc/Comp for one scan.

    Args:
        data_pts: (N, 3) fused cloud; stl_pts: (M, 3) GT structured light
            (assumed pre-thinned like the official stl plys).
        obs_mask/bb/res: observability voxel grid (None = no masking).
        plane: (4,) ground plane; GT point q kept when plane @ [q, 1] > 0.
    """
    data = reduce_points(np.asarray(data_pts, np.float64), dst, seed)

    d_data = nn_distances(data, stl_pts, max_dist)
    if obs_mask is not None and bb is not None:
        in_mask = _mask_lookup(data, obs_mask, bb, res)
    else:
        in_mask = np.ones(len(data), bool)
    acc_d = d_data[in_mask]
    acc_d = acc_d[acc_d < outlier]

    d_stl = nn_distances(stl_pts, data, max_dist)
    if plane is not None:
        above = (np.concatenate([stl_pts, np.ones((len(stl_pts), 1))], 1)
                 @ np.asarray(plane).reshape(4)) > 0
    else:
        above = np.ones(len(stl_pts), bool)
    comp_d = d_stl[above]
    comp_d = comp_d[comp_d < outlier]

    return {
        "acc_mean": float(np.mean(acc_d)) if len(acc_d) else float(max_dist),
        "acc_median": float(np.median(acc_d)) if len(acc_d) else float(max_dist),
        "comp_mean": float(np.mean(comp_d)) if len(comp_d) else float(max_dist),
        "comp_median": float(np.median(comp_d)) if len(comp_d) else float(max_dist),
    }


def load_scan_gt(sample_set_path: str, scan: int, margin: int = 10):
    """Load a scan's GT from the official DTU SampleSet layout
    (stl ply + ObsMask .mat with ObsMask/BB/Res + Plane .mat with P)."""
    from scipy.io import loadmat
    from mdfnet_tpu_torch.fusion.ply import read_ply
    stl, _ = read_ply(os.path.join(sample_set_path, "Points", "stl",
                                   f"stl{scan:03d}_total.ply"))
    m = loadmat(os.path.join(sample_set_path, "ObsMask",
                             f"ObsMask{scan}_{margin}.mat"))
    p = loadmat(os.path.join(sample_set_path, "ObsMask", f"Plane{scan}.mat"))
    return (stl.astype(np.float64), m["ObsMask"], np.asarray(m["BB"]),
            float(np.asarray(m["Res"]).squeeze()), np.asarray(p["P"]).reshape(4))


def evaluate_dtu(ply_dir: str, sample_set_path: str,
                 scans: Sequence[int] = (1, 4, 9, 10, 11, 12, 13, 15, 23, 24,
                                         29, 32, 33, 34, 48, 49, 62, 75, 77,
                                         110, 114, 118),
                 method: str = "ours", light: str = "l3",
                 log_fn=print) -> Dict[str, float]:
    """Evaluate fused clouds named <method><scan:03d>_<light>.ply over the
    standard 22 eval scans. Returns per-scan and aggregate metrics."""
    from mdfnet_tpu_torch.fusion.ply import read_ply
    per_scan = {}
    for scan in scans:
        cloud, _ = read_ply(os.path.join(ply_dir,
                                         f"{method}{scan:03d}_{light}.ply"))
        stl, obs_mask, bb, res, plane = load_scan_gt(sample_set_path, scan)
        r = evaluate_scan(cloud, stl, obs_mask, bb, res, plane)
        per_scan[scan] = r
        if log_fn:
            log_fn(f"scan {scan}: acc {r['acc_mean']:.4f} "
                   f"comp {r['comp_mean']:.4f}")

    acc = float(np.mean([r["acc_mean"] for r in per_scan.values()]))
    comp = float(np.mean([r["comp_mean"] for r in per_scan.values()]))
    return {"acc": acc, "comp": comp, "overall": (acc + comp) / 2,
            "per_scan": per_scan}
