#!/usr/bin/env python3
"""Time the Harris + NMS CUDA kernel's run depth, and the kernel against an
earlier source, on one NVIDIA card.

    python3 harris_bench.py [--old path/to/earlier/harris_nms.cu] [--out results.json]

Builds ``okvis2_torch/csrc/harris_nms.cu`` once per run depth in ``ROWS``
(a copy of the source with its ``constexpr int RB`` line changed, under
``okvis2_torch/_build/bench/``), and the earlier source if given: one
``nvcc`` each, all started together. Each build is held bit for bit against
the plain version at the main path's shape [2,480,752], its octaves and a
few odd shapes, then timed at [2,480,752] with ``chip_smoke.cuda_ms``: cold
L2 (a 128 MB buffer overwritten before each launch, each launch timed
alone) and warm L2 (back-to-back launches). Two yardsticks are timed in the
same way: a one-element kernel and ``imgs.repeat(2, 1, 1)``, a copy of the
kernel's bytes.

With ``--old``, the earlier source is timed against the kernel as it is
(RB 7) in turns (old, new, new, old), cold and warm. Results go to
standard output, one line each, with the card's name and power limit, and
with ``--out`` to a JSON file.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from chip_smoke import H, PEAK_BYTES_PER_S, W, cuda_ms, octaves

ROWS = (7, 6, 8, 9, 12, 16)  # output rows per warp; 7 is the source as it is
RB_LINE = "constexpr int RB = 7;"
# also held bit for bit: ragged, H or W <= 3, a single pixel, C = 3
ODD_SHAPES = [(1, 37, 53), (1, 2, 40), (2, 20, 3), (1, 1, 1), (3, 33, 71)]


def build_all(sources):
    """{tag: .cu path} -> {tag: (library path, ptxas report)}, one nvcc each,
    started together."""
    from okvis2_torch.ops import _build

    procs = {}
    for tag, src in sources.items():
        lib = os.path.join(_build.BUILD_ROOT, "bench", tag, "libharris_nms.so")
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]
        procs[tag] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (lib, cmd, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{text}")
        out[tag] = (lib, _build.ptxas_lines(text))
    return out


def launcher(lib_path):
    """The library's ``harris_nms_launch`` as imgs -> (resp, nms), uncounted."""
    fn = ctypes.CDLL(lib_path).harris_nms_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(imgs):
        resp, nms = torch.empty_like(imgs), torch.empty_like(imgs)
        err = fn(imgs.data_ptr(), resp.data_ptr(), nms.data_ptr(), *imgs.shape, 0.04,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"launch failed ({err})"
        return resp, nms
    return run


def check(run, imgs_by_shape):
    """Bit equality with the plain version at every shape, else raise."""
    from okvis2_torch.ops.harris_cuda import harris_nms_reference

    for imgs in imgs_by_shape:
        (rk, nk), (rp, np_) = run(imgs), harris_nms_reference(imgs)
        assert torch.equal(rk, rp) and torch.equal(nk, np_), (
            f"differs from the plain version at {tuple(imgs.shape)}")


def sass_counts(lib_path):
    """SASS instructions and shuffles of each kernel instance of a library,
    by cuobjdump where the toolkit has it (else {})."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return {}
    counts, fn = {}, None
    for line in subprocess.run([exe, "-sass", lib_path], capture_output=True,
                               text=True).stdout.splitlines():
        if "Function :" in line:
            fn = "vec" if "ILb1E" in line else "scalar"
            counts[fn] = {"instructions": 0, "shfl": 0}
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+[A-Z@]", line):
            counts[fn]["instructions"] += 1
            counts[fn]["shfl"] += "SHFL" in line
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="an earlier harris_nms.cu to time in turns against this one")
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("harris_bench: no CUDA device; this run needs an NVIDIA card", file=sys.stderr)
        return 1
    from okvis2_torch.ops import _build
    from okvis2_torch.utils.synthetic import textured_stereo_pair

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with open(os.path.join(_build.CSRC, "harris_nms.cu")) as f:
        src = f.read()
    assert src.count(RB_LINE) == 1, f"{RB_LINE!r} not found once in harris_nms.cu"
    sources = {}
    for rb in ROWS:
        sources[f"rb{rb}"] = os.path.join(_build.BUILD_ROOT, "bench", f"rb{rb}.cu")
        os.makedirs(os.path.dirname(sources[f"rb{rb}"]), exist_ok=True)
        with open(sources[f"rb{rb}"], "w") as f:
            f.write(src.replace(RB_LINE, f"constexpr int RB = {rb};"))
    if args.old:
        sources["old"] = args.old
    libs = build_all(sources)
    runs = {tag: launcher(lib) for tag, (lib, _) in libs.items()}

    imgs = torch.tensor(textured_stereo_pair(H, W, seed=0), dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    checked = octaves(imgs) + [torch.rand(s, generator=gen, device="cuda") for s in ODD_SHAPES]
    for run in runs.values():
        check(run, checked)
    buf = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > 2x the L2
    l2_flush = buf.zero_  # leaves the L2 full of dirty lines, as chip_smoke.py does
    l2_clean = buf.sum  # leaves it full of clean ones: no write-back on eviction
    bound_ms = 3 * imgs.numel() * imgs.element_size() / PEAK_BYTES_PER_S * 1e3

    def timed(fn):
        return {"cold_l2": cuda_ms(lambda: fn(imgs), l2_flush), "warm_l2": cuda_ms(lambda: fn(imgs))}

    tiny = torch.zeros(1, device="cuda")
    res = {"card": card, "shape": list(imgs.shape), "bound_ms": bound_ms,
           "one_element_ms": timed(lambda _: tiny.add_(1.0)),
           "repeat_ms": timed(lambda x: x.repeat(2, 1, 1)), "configs": []}
    print(f"[yardstick] one-element kernel {json.dumps(res['one_element_ms'])}; "
          f"imgs.repeat(2,1,1) {json.dumps(res['repeat_ms'])}", flush=True)
    for rb in ROWS:
        lib, ptxas = libs[f"rb{rb}"]
        row = {"rows": rb, **timed(runs[f"rb{rb}"]),
               "registers": [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)],
               "spill_bytes": sum(int(b) for b in re.findall(r"(\d+) bytes spill", ptxas)),
               "sass": sass_counts(lib)}
        row["bound_share"] = bound_ms / row["cold_l2"]
        res["configs"].append(row)
        print("[config] " + json.dumps(row), flush=True)
    res["clean_l2_ms"] = {"kernel": cuda_ms(lambda: runs["rb7"](imgs), l2_clean),
                          "repeat": cuda_ms(lambda: imgs.repeat(2, 1, 1), l2_clean),
                          "one_element": cuda_ms(lambda: tiny.add_(1.0), l2_clean)}
    print("[rb7] L2 evicted by a read (clean lines), ms: " + json.dumps(res["clean_l2_ms"]),
          flush=True)
    if args.old:
        res["old_ptxas"] = libs["old"][1]
        res["turns"] = [{"kernel": name, **timed(runs[tag])}
                        for name, tag in (("old", "old"), ("new", "rb7"), ("new", "rb7"),
                                          ("old", "old"))]
        for t in res["turns"]:
            print("[turn] " + json.dumps(t), flush=True)
        mean = {n: sum(t["cold_l2"] for t in res["turns"] if t["kernel"] == n) / 2
                for n in ("old", "new")}
        res["new_over_old_cold_l2"] = mean["new"] / mean["old"]
        print(f"[turns] cold L2: new {mean['new'] * 1e3:.3f} us, old {mean['old'] * 1e3:.3f} us, "
              f"ratio {res['new_over_old_cold_l2']:.4f} ({card})", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
