"""ctypes bindings for the host-side layout engine (counterpart of
capital_tpu/native.py): block <-> block-cyclic redistribution, packed
triangular storage and a blocked transpose, on the host.

The C++ source is the port's own copy, `csrc/layout.cpp`. It is compiled
at first use with the host C++ compiler ($CXX, else c++ or g++) into
`capital_tpu_torch/_build/`, the library's name carrying a digest of the
source and flags. Every entry point has a numpy route, taken when no
compiler or library is present, with the same results. Inputs may be
numpy arrays or torch tensors (copied to the host as f32); outputs are
numpy f32 arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "layout.cpp"
_BUILD = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"liblayout-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    cxx = (os.environ.get("CXX") or shutil.which("c++")
           or shutil.which("g++"))
    if not cxx:
        return False
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


@lru_cache(maxsize=1)
def _lib():
    out = _target()
    if not out.exists() and not _compile(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    i64 = ctypes.c_int64
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    for name, argtypes in [
        ("block_to_cyclic_f32", [fp, fp, i64, i64, i64, i64, i64]),
        ("cyclic_to_block_f32", [fp, fp, i64, i64, i64, i64, i64]),
        ("pack_upper_f32", [fp, fp, i64]),
        ("unpack_upper_f32", [fp, fp, i64]),
        ("pack_lower_f32", [fp, fp, i64]),
        ("unpack_lower_f32", [fp, fp, i64]),
        ("transpose_f32", [fp, fp, i64, i64]),
    ]:
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = None
    return lib


def available() -> bool:
    """Whether the compiled library is in use (else the numpy route)."""
    return _lib() is not None


def _f32c(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


# -- block-cyclic redistribution (ScaLAPACK-interchange layout) -------------

def _cyclic_params(m, n, pr, pc, bb):
    lm = -(-m // (pr * bb)) * bb
    ln = -(-n // (pc * bb)) * bb
    return lm, ln


def _cyclic_index(m, n, pr, pc, bb):
    """(panel, local row, local column) of every global (r, c), broadcast
    to (m, n): process (r // bb) % pr, (c // bb) % pc."""
    r, c = np.arange(m)[:, None], np.arange(n)[None, :]
    panel = ((r // bb) % pr) * pc + (c // bb) % pc
    return (panel, (r // (pr * bb)) * bb + r % bb,
            (c // (pc * bb)) * bb + c % bb)


def block_to_cyclic(a, pr: int, pc: int, bb: int = 1) -> np.ndarray:
    """(m, n) global -> (pr*pc, lm, ln) per-process block-cyclic panels,
    zero-padded (bb = 1 is the pure-cyclic layout)."""
    a = _f32c(a)
    m, n = a.shape
    lm, ln = _cyclic_params(m, n, pr, pc, bb)
    out = np.zeros((pr * pc, lm, ln), np.float32)
    lib = _lib()
    if lib is not None:
        lib.block_to_cyclic_f32(a, out.reshape(-1), m, n, pr, pc, bb)
        return out
    out[_cyclic_index(m, n, pr, pc, bb)] = a
    return out


def cyclic_to_block(panels, m: int, n: int, pr: int, pc: int,
                    bb: int = 1) -> np.ndarray:
    """Inverse of block_to_cyclic."""
    panels = _f32c(panels)
    want = (pr * pc, *_cyclic_params(m, n, pr, pc, bb))
    if panels.shape != want:
        raise ValueError(f"panels of shape {panels.shape}, need {want}")
    lib = _lib()
    if lib is not None:
        out = np.zeros((m, n), np.float32)
        lib.cyclic_to_block_f32(panels.reshape(-1), out, m, n, pr, pc, bb)
        return out
    return np.ascontiguousarray(panels[_cyclic_index(m, n, pr, pc, bb)])


# -- packed triangular storage (checkpoint export at half the bytes) --------

def _packed_order(n: int, upper: bool):
    """Row and column of each packed word: column-major over the
    triangle, column j holding rows 0..j (upper) or j..n-1 (lower)."""
    iu = np.triu_indices(n) if upper else np.tril_indices(n)
    order = np.lexsort((iu[0], iu[1]))
    return iu[0][order], iu[1][order]


def pack_triangle(a, upper: bool = True) -> np.ndarray:
    """Dense (n, n) -> packed 1-D triangle of n(n+1)/2 floats: the upper
    triangle's (row, col) at col*(col+1)/2 + row, the lower's column by
    column from the diagonal down."""
    a = _f32c(a)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"pack_triangle needs a square matrix, not {a.shape}")
    lib = _lib()
    if lib is not None:
        out = np.empty(n * (n + 1) // 2, np.float32)
        (lib.pack_upper_f32 if upper else lib.pack_lower_f32)(a, out, n)
        return out
    return a[_packed_order(n, upper)]


def unpack_triangle(packed, n: int, upper: bool = True) -> np.ndarray:
    """Packed triangle -> dense (n, n), the other triangle zero."""
    packed = _f32c(packed)
    if packed.shape != (n * (n + 1) // 2,):
        raise ValueError(f"{packed.shape} packed words, need n(n+1)/2 for "
                         f"n = {n}")
    out = np.zeros((n, n), np.float32)
    lib = _lib()
    if lib is not None:
        (lib.unpack_upper_f32 if upper else lib.unpack_lower_f32)(packed, out,
                                                                  n)
        return out
    out[_packed_order(n, upper)] = packed
    return out


def transpose(a) -> np.ndarray:
    """Blocked host transpose."""
    a = _f32c(a)
    m, n = a.shape
    lib = _lib()
    if lib is None:
        return np.ascontiguousarray(a.T)
    out = np.empty((n, m), np.float32)
    lib.transpose_f32(a, out, m, n)
    return out
