"""The knee of a live cell: the most streams the loop sustains.

A run passes when no chunk failed, at most ``--skip-share`` of the grid
slots of its window were skipped, and the 95th percentile of a dispatch's
host time is under one period. A count passes when every one of its
``--runs`` runs passes; the knee is the highest count that passes with
every count below it. Frozen stream-hops are printed and do not decide:
they come from host stalls at any load (a dispatch whose host time
outlasts the phase before the next chunk is due pulls that chunk into its
catch-up hop, and the next slot then finds nothing new).

    python3 -m benchmark.sweep --workload pv_serial.live --seed <n> --seconds 60 --runs 2 --streams 1024 1280 1536

Each run is one run of the cell without its comparison, all in this
process, the ``k``-th run of every count on seed ``seed + k``. Prints one
JSON line a run and a last line with the knee. Counts whose host ring bank
(4 s of audio a stream) would take half of the host's memory are left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .run import cache_dirs, run_cell

RING_BYTES_PER_STREAM = 4 * 22050 * 4


def run_once(workload, seed, seconds, streams, skip_share) -> bool:
    record = []
    line = run_cell(workload, seed, seconds, False, traffic={"streams": streams}, compare=False, record=record)
    r = record[0]
    c = r.counters
    slots = c["grid_slots"]
    dispatch = np.array(r.spans["dispatch"])
    p95 = float(np.percentile(dispatch, 95))
    ok = line["failed"] == 0 and c["skipped_deadlines"] <= skip_share * slots and p95 < r.shapes["period"]
    print(json.dumps({"streams": streams, "seed": seed, "pass": bool(ok), "failed": line["failed"],
                      "attempted": line["attempted"], "skipped_deadlines": c["skipped_deadlines"],
                      "grid_slots": slots, "frozen": c["frozen"],
                      "dispatch_ms_p50": 1e3 * float(np.percentile(dispatch, 50)), "dispatch_ms_p95": 1e3 * p95,
                      "host": r.host,
                      "metrics": {k: v["value"] for k, v in line["metrics"].items()}}), flush=True)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=60.0)
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--skip-share", type=float, default=0.015)
    parser.add_argument("--streams", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cache_dirs()
    limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2 / RING_BYTES_PER_STREAM
    knee, first_failure = None, None
    for n in sorted(args.streams):
        if n > limit:
            print(json.dumps({"streams": n, "note": "left out: the host ring bank would take half the host's memory"}))
            break
        results = [run_once(args.workload, args.seed + k, args.seconds, n, args.skip_share) for k in range(args.runs)]
        if all(results):
            knee = n if first_failure is None else knee
        elif first_failure is None:
            first_failure = n
    print(json.dumps({"knee": knee, "first_failure": first_failure, "runs": args.runs, "seconds": args.seconds,
                      "skip_share": args.skip_share}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
