"""Build and bind the package's CUDA kernels.

The sources under `csrc/` are compiled at first use with `nvcc` into one
shared library with a plain C interface, loaded with `ctypes`. The library is
keyed on a hash of the sources and the compiler flags, so a changed source
builds anew and an unchanged one is reused. Nothing here runs at import time:
the CPU tests import every module of the package on a host without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# entry point name -> its argument types; every pointer and the stream is a
# c_void_p, so ctypes passes full 64-bit addresses (masked_attention_fwd then
# takes the dropout threshold as a uint32 and its scale as a float)
ENTRY_POINTS = {
    "masked_attention_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_uint32,
                                                     ctypes.c_float],
    "masked_attention_blocks_per_sm": [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "masked_attention_tma_encode_us": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2,
    "masked_attention_plan": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    # q, k, v, g, bias, dq, dk, dv, dbias, scratch, dims, stream, seed; then
    # the dropout threshold and scale, as masked_attention_fwd takes them
    "masked_attention_bwd": [ctypes.c_void_p] * 13 + [ctypes.c_uint32,
                                                      ctypes.c_float],
    "masked_attention_bwd_plan": [ctypes.c_void_p] * 2,
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of mvp_pytorch_tpu_torch are "
            "built from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def _sources():
    names = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC, f) for f in names]


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(nvcc: str, src: str, obj: str) -> str:
    """One `nvcc -c`; returns the compiler's report (registers, spills)."""
    res = subprocess.run(
        [nvcc, *ARCH, *FLAGS, "-c", src, "-o", obj],
        capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    return res.stderr


def build() -> str:
    """Compile every `csrc/*.cu` (one nvcc each, in parallel) and link them
    into `_build/libmvp_kernels_<hash>.so`. Returns the library's path."""
    lib = os.path.join(BUILD, f"libmvp_kernels_{_digest()}.so")
    if os.path.exists(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(BUILD, exist_ok=True)
    units = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in units]
        with ThreadPoolExecutor(max_workers=len(units)) as pool:
            reports = list(pool.map(functools.partial(_compile, nvcc),
                                    units, objs))
        out = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", out],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
        with open(os.path.join(BUILD, "ptxas.log"), "w") as f:
            f.write("\n".join(reports))
        os.replace(out, lib)        # atomic: a reader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(build())
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def find_cuobjdump() -> str:
    path = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def sass_mma_counts(lib: str) -> dict:
    """Tensor-core instructions in each kernel's SASS in the built library,
    by mangled kernel name, from `cuobjdump --dump-sass`: {"HMMA": n (the
    warp-level `mma.sync`), "HGMMA": n (the warpgroup-level `wgmma`)}."""
    res = subprocess.run([find_cuobjdump(), "--dump-sass", lib],
                         capture_output=True, text=True, check=True)
    counts, name = {}, None
    for line in res.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[name][op] += 1
    return counts
