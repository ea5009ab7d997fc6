"""The landmark-sharded solve across cards, one rank per card over NCCL.

    python3 tools/sharded_ba_cards.py [world sizes, comma-separated]

Needs as many CUDA cards as the largest world size (default 1,2,4). Builds
a full-graph-scale window (``utils/synthetic.build_problem``: 32 states, a
24x24 landmark wall, 0.5 px noise, disturbed, the first pose frozen;
D = 15 S + 6 NC = 492 as the final BA's pack) in float64, solves it
unsharded on card 0 (5 LM iterations), then for each world size spawns one
rank per card (``parallel/dryrun.py::run_spmd``, NCCL) that loads the same
pack and solves it sharded (``solve_saved_pack``). Prints, per world size,
each rank's ms (synchronised wall time of its solve) and device kernels,
the collectives per LM iteration, the shard sizes and the poses' largest
gap to the unsharded solve; then ``dryrun_multichip`` at the largest
world size; and the cards' name and power limit.
"""

import functools
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_ITER = 5


def main(argv):
    from okvis2_torch.parallel import dryrun, shard_problem_by_landmark
    from okvis2_torch.solver.gauss_newton import solve_window
    from okvis2_torch.solver.window_problem import SolverConfig
    from okvis2_torch.utils import synthetic

    sizes = [int(n) for n in (argv[1] if len(argv) > 1 else "1,2,4").split(",")]
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(sizes):
        print(f"sharded_ba_cards: needs {max(sizes)} CUDA cards", file=sys.stderr)
        return 1
    log = functools.partial(print, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    problem, cams, imu, _ = synthetic.build_problem(num_states=32, n_landmarks_side=24,
                                                    obs_noise=0.5, device="cuda")
    problem = synthetic.disturb_problem(problem.replace(
        pose_frozen=torch.arange(problem.S, device="cuda") == 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, st = solve_window(problem, cams, imu, SolverConfig(max_iterations=N_ITER))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref_pose = ref.pose.cpu().numpy()
    log(f"unsharded, card 0: S/L/O {problem.S}/{problem.L}/{problem.O}, {ms:.3f} ms, "
        f"{st['iterations']} LM iterations, cost {float(st['initial_cost']):.6e} -> "
        f"{float(st['final_cost']):.6e}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pack.npz")
        dryrun.save_pack(path, problem, cams, imu)
        for n in sizes:
            sh = shard_problem_by_landmark(problem, n)
            per = [(int(sh.lm_mask[k * sh.L // n:(k + 1) * sh.L // n].sum()),
                    int(sh.obs_mask[k * sh.O // n:(k + 1) * sh.O // n].sum())) for k in range(n)]
            ranks = dryrun.run_spmd(dryrun.solve_saved_pack, n,
                                    args=(path, N_ITER, SolverConfig(), True),
                                    backend="nccl", device="cuda", init_dir=tmp)
            r0 = ranks[0]
            gap = float(np.abs(r0["pose"][:, :3] - ref_pose[:, :3]).max())
            same = all(np.array_equal(r["pose"], r0["pose"]) for r in ranks)
            log(f"world size {n} (NCCL, one card per rank): ms per rank "
                f"{[round(r['ms'], 3) for r in ranks]}, device kernels per rank "
                f"{[r['kernels'] for r in ranks]}, {r0['iterations']} LM iterations (unsharded "
                f"{st['iterations']}), {(r0['collectives'] - 2) / r0['iterations']:g} collectives "
                f"per LM iteration; used landmarks / observations per rank {per}; poses within "
                f"{gap:.3e} m of the unsharded solve; every rank the same result: {same}")
            if r0["iterations"] != st["iterations"] or gap > 1e-8 or not same:
                log("sharded_ba_cards: the sharded solve disagrees with the unsharded one")
                return 1
        dryrun.dryrun_multichip(max(sizes), init_dir=tmp)  # prints its line
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
