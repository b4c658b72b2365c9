"""Run one cell of the port's benchmark once; print its result as the last
line of standard output.

    python3 portbench/run.py --workload tick.tradr --seed 12345 \
        --seconds 45 --trace 0

From the root of a checkout on a machine with an NVIDIA card.  The run
loads and warms up (``setup_s``), measures for ``--seconds``, then checks
what the timed path produced against the plain reference and prints one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error).  It exits non-zero and prints no result without a card, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # the build caches of anything that compiles stay inside the checkout,
    # at fixed paths (the port's kernels build into its own _build/)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness

    def fail(msg: str) -> int:
        print(f"portbench: {msg}", file=sys.stderr)
        return 2

    found = harness.forbidden_modules()
    if found:
        return fail(f"modules loaded that no run may load: {found}")
    manifest = harness.load_manifest()
    try:
        spec = harness.cell_spec(manifest, args.workload)
    except harness.RunError as e:
        return fail(str(e))
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return fail(f"the cell needs {chips} CUDA device(s); this machine "
                    f"has {n}")
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, manifest=manifest, spec=spec)
    found = harness.forbidden_modules()
    if found:
        return fail(f"modules loaded by the run that no run may load: "
                    f"{found}")
    for k, v in out["info"].items():
        print(f"info {k} {v!r}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
