"""The benchmark of ``mdfnet_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks``: every number compared with its limit), and
the numbers compared with their limits last on standard error. Exits
non-zero, printing no result, without a card, with fewer cards than the
cell asks for, or when JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench.lib import harness, report

    cell = harness.load_cell(args.workload, ROOT)
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}: the port's benchmark "
              f"may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    line = report.result_line(cell, res, bool(args.trace))
    print("set-up, seconds from the start: " + ", ".join(
        f"{k} {v}" for k, v in res["phases"].items()), file=sys.stderr)
    sys.stdout.flush()
    for text in report.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
