"""The readings that the limits of a cell are set from, for many seeds in
one process: the program as its configuration states it (the lower
readings), and the control, the program with its own lower-precision path
switched on (``fast=True``: the VQT's weights and frames in bf16; the
upper readings).

    python3 -m benchmark.control --workload <name> --seconds <s> --seeds <n> ... [--fast 0 1]

Each run prints one JSON line: the workload, seed, precision, readings and
whether the cell's limits held. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from .run import cache_dirs, run_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fast", type=int, nargs="+", choices=(0, 1), default=[0, 1])
    args = parser.parse_args(argv)
    cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    for fast in args.fast:
        for seed in args.seeds:
            record = []
            line = run_cell(args.workload, seed, args.seconds, False, fast=bool(fast), record=record)
            print(json.dumps({"workload": args.workload, "seed": seed, "fast": bool(fast),
                              "readings": record[0].readings, "correct": line["correct"],
                              "failed": line["failed"], "attempted": line["attempted"],
                              "metrics": {k: v["value"] for k, v in line["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
