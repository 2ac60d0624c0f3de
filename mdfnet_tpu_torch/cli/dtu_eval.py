"""DTU metric CLI of the port (twin of ``mdfnet_tpu/cli/dtu_eval.py``, the
replacement for the reference's MATLAB pipeline):

    python -m mdfnet_tpu_torch.cli.dtu_eval --ply_dir plys \\
        --sample_set /path/SampleSet/MVSData [--scans ...] [--method ours]

Host code (numpy and a scipy KD-tree): it takes no ``--device``. Prints one
JSON line with Acc, Comp and Overall.
"""
from __future__ import annotations

import argparse
import json
import logging


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s-%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description="DTU Acc/Comp/Overall")
    parser.add_argument("--ply_dir", required=True)
    parser.add_argument("--sample_set", required=True,
                        help="path to the DTU SampleSet/MVSData directory")
    parser.add_argument("--scans", default=None)
    parser.add_argument("--method", default="ours")
    args = parser.parse_args(argv)

    from mdfnet_tpu_torch.benchmarks.dtu_metric import evaluate_dtu
    kwargs = {}
    if args.scans:
        kwargs["scans"] = [int(s) for s in args.scans.split(",")]
    result = evaluate_dtu(args.ply_dir, args.sample_set, method=args.method,
                          **kwargs)
    print(json.dumps({k: v for k, v in result.items() if k != "per_scan"}))
    return result


if __name__ == "__main__":
    main()
