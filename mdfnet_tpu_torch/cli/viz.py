"""Developer visualisation utilities of the port (the port's copy of
``mdfnet_tpu/cli/viz.py``; host code, no card). matplotlib is imported
only by the commands that draw, so the others run where it is missing.

Covers the reference's tools/script/ helpers:
    catpfm   — render a PFM depth/confidence map to a color PNG
               (reference catfm.py / catpfm_filter_save.py)
    lossplot — plot pth/epoch_loss.txt to a PNG (reference catloss.py uses
               visdom; headless matplotlib here)
    rescale-cams — multiply cam intrinsics by a factor in-place-to-new-dir
               (reference makecams.py)

    python -m mdfnet_tpu_torch.cli.viz catpfm depth.pfm out.png [--clip-min A --clip-max B]
    python -m mdfnet_tpu_torch.cli.viz lossplot pth/epoch_loss.txt out.png
    python -m mdfnet_tpu_torch.cli.viz rescale-cams camdir outdir --factor 4
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def catpfm(args):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mdfnet_tpu_torch.data.formats import read_pfm
    data, _ = read_pfm(args.src)
    if args.clip_min is not None or args.clip_max is not None:
        data = np.clip(data, args.clip_min, args.clip_max)
    plt.figure(figsize=(12, 9))
    plt.imshow(data, cmap=args.cmap)
    plt.colorbar()
    plt.tight_layout()
    plt.savefig(args.dst, dpi=120)
    print(f"wrote {args.dst}")


def lossplot(args):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    losses = [float(x) for x in open(args.src) if x.strip()]
    plt.figure(figsize=(8, 5))
    plt.plot(np.arange(1, len(losses) + 1), losses, marker="o")
    plt.xlabel("epoch")
    plt.ylabel("mean loss")
    plt.grid(True, alpha=0.3)
    plt.savefig(args.dst, dpi=120)
    print(f"wrote {args.dst}")


def rescale_cams(args):
    from mdfnet_tpu_torch.data.formats import read_cam_file, write_cam_file
    os.makedirs(args.dst, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.src)):
        if not name.endswith("_cam.txt"):
            continue
        k, e, info = read_cam_file(os.path.join(args.src, name))
        k = k.copy()
        k[:2] *= args.factor
        write_cam_file(os.path.join(args.dst, name), k, e, info)
        n += 1
    print(f"rescaled {n} cam files x{args.factor} -> {args.dst}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="mdfnet_tpu_torch viz utilities")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("catpfm")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--clip-min", type=float, default=None)
    p.add_argument("--clip-max", type=float, default=None)
    p.add_argument("--cmap", default="turbo")
    p.set_defaults(fn=catpfm)

    p = sub.add_parser("lossplot")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(fn=lossplot)

    p = sub.add_parser("rescale-cams")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--factor", type=float, default=4.0)
    p.set_defaults(fn=rescale_cams)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
