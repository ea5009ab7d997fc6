"""Readings for the correctness limits: the program, its control (TF32
matrix products and convolutions switched on) and the program with a
fault of ``slambench/faults.py`` planted (``unchanged``, ``half_rows``,
``fewer_iterations``), on several seeds of a cell, in one process on the
card.

    python3 slambench/control.py --workload <name> --seeds 1,2,3 --seconds <s> \\
        [--modes program,control,half_rows] [--out <file.jsonl>]

Prints one JSON line per run: the workload, seed, mode, every number the
checks computed, ``correct`` and the end-to-end metrics. The benchmark's
own runs never run the control or a fault.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slambench import faults, harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            t0 = time.time()
            undo = faults.plant(mode) if mode in faults.SOLVE_FAULTS else (lambda: None)
            try:
                result, numbers = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                                                   log=log, control=(mode == "control"))
            finally:
                undo()
            line = json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                               "numbers": numbers, "correct": result["correct"],
                               "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                               "attempted": result["attempted"]})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
