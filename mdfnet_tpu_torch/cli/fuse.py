"""Fusion CLI of the port (twin of ``mdfnet_tpu/cli/fuse.py``): one front end
for the three backends.

    python -m mdfnet_tpu_torch.cli.fuse -m filter|vote|pcd -d dtu|tanks
        [-s intermediate|advanced] [--root DIR] [-e EVAL_DIR] [-o OUT_DIR]
        [--scans ...] [--photo-thresh P] [--device cuda|cpu]

Per-dataset defaults mirror the reference: filter uses photo 0.8 +
nconditions 5 (1 for tanks advanced, dynamic_filter_gpu.py:259-284); vote
uses the per-scene presets (DTU: prob 0.6 / disp 0.25 / 3 consistent views,
gipuma/conf.py:34-36); pcd uses prob 0.8 / 10 views / vthresh 4
(pcd/fusion.py:274-291). DTU output plys are named ours<scan:03d>_l3.ply,
the name the DTU metric expects. The per-view passes run on the card
(``--device cuda``, the default; with no card the CLI exits with an error)
or, when asked, on the CPU; pcd's election and segment filter run on the
host in the native library either way. ``main`` returns, per scan, the
ply's path, its point count, the wall seconds and (pcd) the seconds by part.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

from mdfnet_tpu_torch.config import DataConfig
from mdfnet_tpu_torch.models.registry import resolve_device

log = logging.getLogger("mdfnet_tpu_torch.fuse")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s-%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description="mdfnet_tpu_torch fusion")
    parser.add_argument("-m", "--method", default="filter",
                        choices=["filter", "vote", "pcd"])
    parser.add_argument("-d", "--dataset", default="dtu",
                        choices=["dtu", "tanks"])
    parser.add_argument("-s", "--set", default="intermediate",
                        choices=["intermediate", "advanced"])
    parser.add_argument("--root", default=None)
    parser.add_argument("-e", "--eval_dir", default="outputs")
    parser.add_argument("-o", "--out_dir", default="plys")
    parser.add_argument("--scans", default=None)
    parser.add_argument("--photo-thresh", type=float, default=None,
                        help="photometric confidence threshold override "
                             "(default: the reference's per-method value; "
                             "lower it for weakly-trained checkpoints)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; fails without a card) or cpu")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))

    data_cfg = DataConfig(root_dir=args.root) if args.root else DataConfig()

    if args.dataset == "dtu":
        root = os.path.join(data_cfg.root_dir, data_cfg.dtu_eval_subdir)
        scans = ([int(s) for s in args.scans.split(",")] if args.scans
                 else data_cfg.dtu_eval_scans)
        jobs = [(os.path.join(root, f"scan{s}"),
                 os.path.join(args.eval_dir, f"scan{s}"),
                 os.path.join(args.out_dir, f"ours{s:03d}_l3.ply"),
                 "cams") for s in scans]
        nconditions = 5
    else:
        root = os.path.join(data_cfg.root_dir, data_cfg.tanks_subdir, args.set)
        scenes = (args.scans.split(",") if args.scans else
                  (data_cfg.tanks_intermediate if args.set == "intermediate"
                   else data_cfg.tanks_advanced))
        jobs = [(os.path.join(root, scene),
                 os.path.join(args.eval_dir, scene),
                 os.path.join(args.out_dir, f"{scene}.ply"),
                 "cams_1") for scene in scenes]
        nconditions = 5 if args.set == "intermediate" else 1

    results = []
    for scan_dir, eval_dir, out_ply, cam_folder in jobs:
        log.info("fusing %s -> %s on %s", eval_dir, out_ply, device)
        t0, times = time.perf_counter(), {}
        if args.method == "filter":
            from mdfnet_tpu_torch.fusion.dynamic_filter import fuse_scan
            xyz = fuse_scan(scan_dir, eval_dir, out_ply,
                            cam_folder=cam_folder,
                            photo_thresh=(0.8 if args.photo_thresh is None
                                          else args.photo_thresh),
                            nconditions=nconditions, log_fn=log.info,
                            device=device)
        elif args.method == "vote":
            from mdfnet_tpu_torch.fusion.consistency_vote import fuse_scan_vote
            from mdfnet_tpu_torch.fusion.presets import vote_preset
            scene_name = os.path.basename(scan_dir.rstrip("/"))
            preset = vote_preset(
                "dtu" if args.dataset == "dtu" else args.set, scene_name)
            log.info("vote preset for %s: %s", scene_name, preset)
            if args.photo_thresh is not None:
                preset = dict(preset, prob_thresh=args.photo_thresh)
            xyz = fuse_scan_vote(scan_dir, eval_dir, out_ply,
                                 cam_folder=cam_folder, log_fn=log.info,
                                 device=device, **preset)
        else:
            from mdfnet_tpu_torch.fusion.pcd_fusion import fuse_scan_pcd
            xyz = fuse_scan_pcd(scan_dir, eval_dir, out_ply,
                                cam_folder=cam_folder,
                                prob_thresh=(0.8 if args.photo_thresh is None
                                             else args.photo_thresh),
                                nviews=10, vthresh=4, log_fn=log.info,
                                device=device, times=times)
            log.info("pcd seconds by part: %s",
                     ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        results.append({"ply": out_ply, "points": len(xyz),
                        "seconds": time.perf_counter() - t0, "times": times})
    return results


if __name__ == "__main__":
    main()
