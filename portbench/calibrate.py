"""Read the numbers that decide ``correct`` over many seeds in one process,
for the program and for what stands in its place (the control, a planted
fault), to set each check's limit from its readings.

    python3 portbench/calibrate.py --workload tick.tradr --seconds 8 \
        --seeds 11 12 13 --systems program control \
        --out runs/calibrate-tick.json

Each (system, seed) is one ``harness.run`` of ``--seconds`` with the
cell's own sizes; the benchmark's own runs never run this.  The limits
in ``workloads/<cell>.json`` are not applied here: every reading is
written out whole.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--systems", nargs="+", default=["program"])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--check-within", type=int, default=None,
                   help="draw the compared units among this many first")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    manifest = harness.load_manifest()
    spec = harness.cell_spec(manifest, args.workload)
    if args.check_within:
        spec["limits"]["check_within"] = args.check_within
    rows = []
    for system in args.systems:
        for seed in args.seeds:
            t0 = time.perf_counter()
            out = harness.run(args.workload, seed, args.seconds, False, t0,
                              manifest=manifest, spec=spec, system=system)
            row = {"system": system, "seed": seed, "metrics": out["metrics"],
                   "attempted": out["attempted"], "failed": out["failed"],
                   "readings": {**out["info"], **{
                       k: c["value"] for k, c in out["checks"].items()}},
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    found = harness.forbidden_modules()
    print("forbidden modules:", found, flush=True)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
