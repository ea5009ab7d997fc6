"""The benchmark of okvis2_torch on NVIDIA GPUs: one run of one cell.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's system from its
configuration, generates its traffic from the seed, warms up (set-up),
measures for ``--seconds`` of time inside the port's calls, checks what
the timed path produced against the plain references, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` (each compared number beside its limit), which also end
standard error. It exits non-zero without printing a result when there
is no card, when the cell asks for more cards than there are, or when a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, ".slambench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from slambench import harness

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"slambench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("slambench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"slambench: {args.workload} needs {cells[args.workload]['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result, numbers = harness.run_cell(args.workload, args.seed, args.seconds,
                                       bool(args.trace), T_START, log=log)
    log("[slambench] numbers " + json.dumps(numbers))
    bad = harness.forbidden_modules()
    if bad:
        print(f"slambench: loaded modules of JAX or the JAX package: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
