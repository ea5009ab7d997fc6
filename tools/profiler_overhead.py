"""What torch.profiler costs on the card, traced with host ops and device
activity against device activity alone (the choice behind
``chip_smoke.py``'s ``profile_kernels`` and ``profile_frame``): one
3-iteration solve of the smoke run's 12-state float32 window
(``chip_smoke.build_window``), untraced, then under each tracing, with the
device kernels counted, their busy time, the traced run's wall time and
the time ``key_averages()`` takes to sum the trace.

    python3 tools/profiler_overhead.py    # on a machine with a CUDA card

Prints the card's name and power limit, then one line per tracing mode.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from okvis2_torch.solver import SolverConfig, solve_window

    if not torch.cuda.is_available():
        print("profiler_overhead: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    prob, cams, imu, _ = chip_smoke.build_window()
    cfg = SolverConfig(max_iterations=3)

    def solve():
        solve_window(prob, cams, imu, cfg)
        torch.cuda.synchronize()

    solve()  # warm-up
    t = time.perf_counter()
    solve()
    print(f"untraced solve: {time.perf_counter() - t:.3f} s")
    for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]):
        t = time.perf_counter()
        with profile(activities=acts) as prof:
            solve()
        t1 = time.perf_counter()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        print(f"{'+'.join(a.name for a in acts)}: {sum(e.count for e in kern)} device kernels, "
              f"busy {sum(e.self_device_time_total for e in kern) / 1e3:.3f} ms, traced solve "
              f"{t1 - t:.3f} s, key_averages {time.perf_counter() - t1:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
