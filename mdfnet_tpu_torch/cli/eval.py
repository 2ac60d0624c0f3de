"""Evaluation CLI of the port (twin of ``mdfnet_tpu/cli/eval.py``):

    python -m mdfnet_tpu_torch.cli.eval -p CKPT.pth [--root DIR]
        [-o OUTPUT] [--scans ...]

The DTU eval set only (Tanks & Temples is not ported yet). CKPT is a
reference-schema ``.pth`` ({'epoch', 'model'}). On a CUDA device
the model runs the hand-written kernels with bf16 convs (f32 geometry,
softmax and fitting); on the CPU it runs the plain versions in f32.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from mdfnet_tpu.config import DataConfig, EvalConfig, ModelConfig
from mdfnet_tpu.data.datasets import DTUEvalDataset
from mdfnet_tpu_torch.evaluate import run_eval
from mdfnet_tpu_torch.models.registry import build_model
from mdfnet_tpu_torch.utils.weights import load_checkpoint

log = logging.getLogger("mdfnet_tpu_torch.eval")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s-%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description="mdfnet_tpu_torch evaluation")
    parser.add_argument("-p", "--pre_model", required=True,
                        help="reference-schema .pth checkpoint")
    parser.add_argument("--root", default=None)
    parser.add_argument("-o", "--output", default="outputs")
    parser.add_argument("--scans", default=None,
                        help="comma-separated DTU scan ids")
    args = parser.parse_args(argv)

    data_cfg = DataConfig(root_dir=args.root) if args.root else DataConfig()
    on_card = torch.cuda.is_available()
    device = torch.device("cuda" if on_card else "cpu")
    model = build_model(ModelConfig(
        compute_dtype="bfloat16" if on_card else "float32"), device=device)
    epoch = load_checkpoint(model, args.pre_model)
    log.info("loaded %s (epoch %d) on %s", args.pre_model, epoch,
             torch.cuda.get_device_name(0) if on_card else "cpu")

    scans = ([int(s) for s in args.scans.split(",")] if args.scans
             else data_cfg.dtu_eval_scans)
    dataset = DTUEvalDataset(
        os.path.join(data_cfg.root_dir, data_cfg.dtu_eval_subdir),
        scans=scans, nviews=EvalConfig().nviews,
        crop_height=data_cfg.dtu_eval_crop_height)
    stats = run_eval(model, dataset, args.output)
    log.info("done: first map %.3f s; %.4f s/view device, %.4f s/view wall "
             "(incl. IO) over %d views", stats["first_map_sec"],
             stats["device_sec_per_view"], stats["wall_sec_per_view"],
             stats["n_views"])
    return stats


if __name__ == "__main__":
    main()
