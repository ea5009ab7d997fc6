"""Build the port's CUDA and host C++ sources into shared libraries, on
first use.

The kernel has a plain C interface (an ``extern "C"`` launcher that returns
``cudaGetLastError()``), so ``nvcc`` compiles it in seconds without
PyTorch's headers; the library is loaded with ``ctypes``. The build goes to
``okvis2_torch/_build/<hash of the source and flags>/`` (listed in
``.gitignore``), so an edited source rebuilds and an unchanged one loads
the library already built. ``-Xptxas -v`` is on: the build keeps what
ptxas reported (registers, shared memory, spills) beside the library, for
``ptxas_report``. There is no fallback: without ``nvcc`` or on a failed
build this raises.

Host sources (``okvis2_torch/native/<name>.cpp``, plain C interfaces with
no CUDA) are built the same way with the host compiler (``$CXX``, else
``g++`` or ``c++``): ``build_host`` / ``load_host_library``, into the same
hash-keyed directories, raising on a failed build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NATIVE = os.path.join(_PKG, "native")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-pthread")


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "okvis2_torch: nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
        "kernels are built from okvis2_torch/csrc on first use"
    )


def ptxas_lines(nvcc_output: str) -> str:
    """The lines of ``nvcc -Xptxas -v`` output that ptxas wrote."""
    return "\n".join(ln.strip() for ln in nvcc_output.splitlines()
                     if "ptxas" in ln or "spill" in ln)


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("okvis2_torch: no host C++ compiler ($CXX, g++ or c++); the host "
                       "libraries are built from okvis2_torch/native on first use")


def _keyed_path(flags, src: str, name: str) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], f"lib{name}.so")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to, keyed by its source and flags."""
    return _keyed_path(NVCC_FLAGS, os.path.join(CSRC, f"{name}.cu"), name)


def host_library_path(name: str) -> str:
    """Where ``native/<name>.cpp`` is built to, keyed by its source and flags."""
    return _keyed_path(CXX_FLAGS, os.path.join(NATIVE, f"{name}.cpp"), name)


def _compile(compiler: str, flags, src: str, lib: str) -> str:
    """Compile ``src`` to ``lib`` through a temporary file renamed into
    place (atomic: concurrent builds agree); raises on failure. Returns the
    compiler's output."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, src]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"okvis2_torch: build failed:\n{' '.join(cmd)}\n{p.stdout}\n{p.stderr}")
    os.replace(tmp, lib)
    return p.stdout + p.stderr


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    wall seconds spent (0.0 if it was)."""
    lib = library_path(name)
    if os.path.exists(lib):
        return 0.0
    t0 = time.perf_counter()
    out = _compile(find_nvcc(), NVCC_FLAGS, os.path.join(CSRC, f"{name}.cu"), lib)
    with open(f"{lib}.ptxas.txt", "w") as f:
        f.write(ptxas_lines(out) + "\n")
    return time.perf_counter() - t0


def build_host(name: str) -> float:
    """Compile ``native/<name>.cpp`` with the host compiler unless it is
    built already. Returns the wall seconds spent (0.0 if it was)."""
    lib = host_library_path(name)
    if os.path.exists(lib):
        return 0.0
    t0 = time.perf_counter()
    _compile(find_cxx(), CXX_FLAGS, os.path.join(NATIVE, f"{name}.cpp"), lib)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """What ptxas reported when ``csrc/<name>.cu`` was built."""
    with open(f"{library_path(name)}.ptxas.txt") as f:
        return f.read().strip()


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; cached per process."""
    build(name)
    return ctypes.CDLL(library_path(name))


@functools.lru_cache(maxsize=None)
def load_host_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one host library; cached per process
    (a failed build is not cached: the next call tries again)."""
    build_host(name)
    return ctypes.CDLL(host_library_path(name))
