"""Build the CUDA kernels at first use and bind them with ctypes.

Each `csrc/*.cu` becomes its own shared library with a plain C interface,
compiled by `nvcc -gencode arch=compute_90a,code=sm_90a` (Hopper). All
missing libraries are compiled together, one `nvcc` per source, the first
time any kernel is needed. A library's file name carries a digest of its
sources, so an edited source is never served from a stale build. Builds
land in `capital_tpu_torch/_build/` (ignored by git).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("trmm_upper", "syrk_upper", "chol_inv", "getrf_leaf")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return cand


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every library in `names` that is not built yet, all at once.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc {name}.cu failed:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `fn_name` of library `lib_name` (built on demand),
    declared with `argtypes` and an int (cudaError_t) result."""
    if lib_name not in _libs:
        build()
        _libs[lib_name] = ctypes.CDLL(str(_target(lib_name)))
    fn = getattr(_libs[lib_name], fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        es = _libs[lib_name].capital_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err}: {es(err).decode()}")
