"""Two host threads launching the port's small kernels on one NVIDIA card.

    python tools/thread_contention.py [repeats]

The pipelined SLAM loop runs its window solves on a worker thread (its own
CUDA stream) while the main thread launches the next frame's tracking
program; both are host-bound Python that launches thousands of small
kernels. This times, on the card, the bench window's 3-iteration solve
(chip_smoke.py phase 5's 12-state window, float32):
  alone        ``repeats`` solves on the main thread, one after another;
  two threads  the same ``repeats`` solves on each of two threads at once,
               one of them on a stream of its own, as the loop's worker;
and prints the wall time per solve of each, and the process's CPU time
(user + system) per solve. If the interpreter lock only serialised the two
threads, a solve would take twice as long with two threads and the CPU time
per solve would stay; a longer wall time, or more CPU time, is what
handing the lock over between the threads costs. Needs a CUDA card; prints
the card's name and power limit first.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    if not torch.cuda.is_available():
        print("thread_contention: needs a CUDA card", file=sys.stderr)
        return 1
    repeats = int(argv[1]) if len(argv) > 1 else 4
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from chip_smoke import build_window
    from okvis2_torch.solver import SolverConfig, solve_window

    problem, cams, imu = build_window()[:3]
    cfg = SolverConfig(max_iterations=3)

    def solves(n, stream=None):
        times = []
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            for _ in range(n):
                t0 = time.perf_counter()
                solve_window(problem, cams, imu, cfg)
                torch.cuda.current_stream().synchronize()
                times.append(time.perf_counter() - t0)
        return times

    solves(2)  # warm-up
    torch.cuda.synchronize()
    c0, t0 = time.process_time(), time.perf_counter()
    alone = solves(repeats)
    cpu_alone, wall_alone = time.process_time() - c0, time.perf_counter() - t0

    out = {}
    worker_stream = torch.cuda.Stream()
    th = threading.Thread(target=lambda: out.__setitem__("worker", solves(repeats, worker_stream)))
    c0, t0 = time.process_time(), time.perf_counter()
    th.start()
    main_times = solves(repeats)
    th.join()
    cpu_two, wall_two = time.process_time() - c0, time.perf_counter() - t0
    res = {
        "solve_ms_alone": statistics.median(alone) * 1e3,
        "solve_ms_two_threads_main": statistics.median(main_times) * 1e3,
        "solve_ms_two_threads_worker": statistics.median(out["worker"]) * 1e3,
        "wall_s_alone": wall_alone, "wall_s_two_threads": wall_two,
        "cpu_ms_per_solve_alone": cpu_alone / repeats * 1e3,
        "cpu_ms_per_solve_two_threads": cpu_two / (2 * repeats) * 1e3,
        "repeats": repeats, "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
