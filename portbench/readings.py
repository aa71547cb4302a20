"""The readings that set a cell's limits: for each seed, one short run of the
cell with the program and the control read on the same requests, in one
process (the libraries built once).

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...]

Each run's window is the cycle's first two calls, its shortest and its
longest (the longest call of the mix is always compared). Prints one JSON
line a seed: the program's numbers (``checks``) and the
control's (``control``), with the window's requests and frames. Not part of
a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = run.run_cell(args.workload, seed, 0.0, False, control=True, calls=args.calls)
        print(json.dumps({"workload": args.workload, "seed": seed, "attempted": r["attempted"],
                          "failed": r["failed"], "metrics": r["metrics"],
                          "checks": {k: c["value"] for k, c in r["checks"].items()},
                          "control": r["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
