"""Evaluation CLI of the port (twin of ``mdfnet_tpu/cli/eval.py``):

    python -m mdfnet_tpu_torch.cli.eval -p CKPT.pth -d dtu|tanks
        [-s intermediate|advanced] [--root DIR] [-o OUTPUT] [--scans ...]
        [--exact] [--spatial N] [--device cuda|cpu] [--trace PATH]

CKPT is a reference-schema ``.pth`` ({'epoch', 'model'}). DTU runs 5 views
at 1600x1184; Tanks & Temples 11 views cropped to 1056 rows, per-scene
``pair.txt`` and ``cams_1``. On the card (``--device cuda``, the default;
with no card it exits with an error) the model runs the hand-written kernels
with bf16 convs (f32 geometry, softmax and fitting); ``--exact`` runs the
same kernels in f32, the port's counterpart of the JAX package's f32 gather
path. ``--device cpu`` runs the plain versions in f32.

``--spatial N`` shards the image height over N ranks (exact halo-exchange
sharding, ``parallel/spatial.py``; 1/N of every image, feature, volume
and output a rank): the crop is aligned down to a multiple of 32 N
(:func:`align_crop`, as the JAX CLI does), the kernels are built once,
then N processes meet over TCP on localhost (NCCL with a card a rank, else
gloo: ranks that share a card, or ``--device cpu``); every rank loads the
checkpoint and rank 0 alone writes the files.

``--trace PATH`` profiles maps 2-11 with torch.profiler (the host and the
card) and writes the Chrome trace, which holds the port's spans
(``utils/tracing.py``), to PATH; the log gets the spans' count and host
ms a map over the same maps. One process only (not with ``--spatial``).
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from mdfnet_tpu_torch.config import DataConfig, EvalConfig, ModelConfig
from mdfnet_tpu_torch.data import DTUEvalDataset, TanksEvalDataset
from mdfnet_tpu_torch.evaluate import run_eval
from mdfnet_tpu_torch.models.registry import build_model, resolve_device
from mdfnet_tpu_torch.utils.weights import load_checkpoint

log = logging.getLogger("mdfnet_tpu_torch.eval")


def align_crop(h: int, spatial: int) -> int:
    """The eval crop for ``spatial`` ranks: band starts must sit on the
    deepest conv grid (32 rows), so the crop is aligned down to a multiple
    of 32 N (JAX ``cli/eval.py:96-108``; the same divisibility workaround
    as the reference's 1200 -> 1184 crop). N = 1 keeps the crop."""
    if spatial <= 1:
        return h
    unit = 32 * spatial
    aligned = (h // unit) * unit
    if aligned != h:
        log.info("spatial=%d: crop height %d -> %d (32*N alignment)",
                 spatial, h, aligned)
    return aligned


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s-%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description="mdfnet_tpu_torch evaluation")
    parser.add_argument("-p", "--pre_model", required=True,
                        help="reference-schema .pth checkpoint")
    parser.add_argument("-d", "--dataset", default="dtu",
                        choices=["dtu", "tanks"])
    parser.add_argument("-s", "--set", default="intermediate",
                        choices=["intermediate", "advanced"])
    parser.add_argument("--root", default=None)
    parser.add_argument("-o", "--output", default="outputs")
    parser.add_argument("--scans", default=None,
                        help="comma-separated scan ids (dtu) or scene names "
                             "(tanks)")
    parser.add_argument("--exact", action="store_true",
                        help="run the kernels in f32 on the card (the CPU "
                             "always runs f32)")
    parser.add_argument("--spatial", type=int, default=1, metavar="N",
                        help="shard the image height over N ranks (exact "
                             "halo-exchange sharding; the crop is aligned "
                             "to a multiple of 32 N)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; fails without a card) or cpu "
                             "(the plain versions in f32)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="profile maps 2-11 and write their Chrome "
                             "trace, with the port's spans, to PATH")
    args = parser.parse_args(argv)
    if args.spatial < 1:
        parser.error(f"--spatial {args.spatial}: at least 1 rank")
    if args.trace and args.spatial > 1:
        parser.error("--trace profiles one process: not with --spatial")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))

    data_cfg = DataConfig(root_dir=args.root) if args.root else DataConfig()
    on_card = device.type == "cuda"
    dtype = "bfloat16" if on_card and not args.exact else "float32"
    model = build_model(ModelConfig(compute_dtype=dtype), device=device)
    epoch = load_checkpoint(model, args.pre_model)
    log.info("loaded %s (epoch %d) on %s, %s", args.pre_model, epoch,
             torch.cuda.get_device_name(0) if on_card else "cpu", dtype)

    if args.dataset == "dtu":
        scans = ([int(s) for s in args.scans.split(",")] if args.scans
                 else data_cfg.dtu_eval_scans)
        dataset = DTUEvalDataset(
            os.path.join(data_cfg.root_dir, data_cfg.dtu_eval_subdir),
            scans=scans, nviews=EvalConfig().nviews,
            crop_height=align_crop(data_cfg.dtu_eval_crop_height,
                                   args.spatial))
    else:
        scenes = (args.scans.split(",") if args.scans else
                  (data_cfg.tanks_intermediate if args.set == "intermediate"
                   else data_cfg.tanks_advanced))
        dataset = TanksEvalDataset(
            os.path.join(data_cfg.root_dir, data_cfg.tanks_subdir, args.set),
            scenes=scenes, nviews=11,
            crop_height=align_crop(data_cfg.tanks_crop_height,
                                   args.spatial))
    stats = run_eval(model, dataset, args.output, spatial=args.spatial,
                     checkpoint=args.pre_model, trace=args.trace)
    log.info("done: first map %.3f s; %.4f s/view forward with its copies "
             "(host clock), %.4f s/view wall (incl. IO) over %d views",
             stats["first_map_sec"], stats["device_sec_per_view"],
             stats["wall_sec_per_view"], stats["n_views"])
    return stats


if __name__ == "__main__":
    main()
