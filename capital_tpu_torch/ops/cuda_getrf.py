"""Partial-pivoting LU of a tall strip, the leaf of the recursive LU panel
(counterpart of capital_tpu/ops/pallas_getrf.py::getrf_leaf_pallas).

    getrf_leaf(strip) -> (lu, pj, pivots)

  lu:     the factored strip, row-swapped: strict lower part L (unit
          diagonal implicit), upper part U; it is `strip` itself, which is
          overwritten;
  pj:     (mm,) int32 with lu = (input)[pj];
  pivots: (ib,) int32 LAPACK swap targets, local to the strip.

Elimination by masking (the Pallas kernel's step rule): column c takes the
not-done row with the largest |.| as pivot, the smallest original row
among ties (LAPACK's isamax picks the first row in swapped order, so the
two agree up to ties); the other not-done rows get multipliers t / pivval
(a zero pivot divides by 1) and a rank-1 update of the later columns,
computed as a product followed by a subtraction.

On a CUDA tensor the cooperative kernel of `csrc/getrf_leaf.cu` runs it
(f32, ib <= 128, any height, any row stride); on a CPU tensor
`getrf_leaf_plain` repeats the same step rule on tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from capital_tpu_torch.ops import _build

MAX_IB = 128      # the kernel's widest strip (its pivot row in shared memory)
_MAX_BLOCKS = 4096  # candidate slots per parity; the grid is far smaller

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def _check(strip: torch.Tensor) -> None:
    if strip.ndim != 2 or strip.shape[0] < strip.shape[1]:
        raise ValueError(f"getrf_leaf needs an (mm, ib) strip with mm >= ib, "
                         f"got {tuple(strip.shape)}")


def getrf_leaf(strip: torch.Tensor):
    """Factor `strip` in place; returns (strip, pj, pivots) (module doc)."""
    _check(strip)
    if not strip.is_cuda:
        return getrf_leaf_plain(strip)
    mm, ib = strip.shape
    if strip.dtype != torch.float32:
        raise TypeError(f"getrf_leaf kernel takes f32, got {strip.dtype} "
                        "(CAPITAL_LU_LEAF=jax runs the plain leaf)")
    if ib > MAX_IB or strip.stride(1) != 1:
        raise ValueError(f"getrf_leaf kernel needs ib <= {MAX_IB} and a unit "
                         f"column stride, got {tuple(strip.shape)} with "
                         f"strides {strip.stride()}")
    dev = strip.device
    pj = torch.empty(mm, dtype=torch.int32, device=dev)
    invp = torch.empty(mm, dtype=torch.int32, device=dev)
    done = torch.empty(mm, dtype=torch.int32, device=dev)
    piv = torch.empty(ib, dtype=torch.int32, device=dev)
    slot_v = torch.empty(2 * _MAX_BLOCKS, dtype=torch.float32, device=dev)
    slot_r = torch.empty(2 * _MAX_BLOCKS, dtype=torch.int32, device=dev)
    fn = _build.function("getrf_leaf", "capital_getrf_leaf", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(strip.data_ptr(), strip.stride(0), mm, ib, pj.data_ptr(),
                 invp.data_ptr(), done.data_ptr(), piv.data_ptr(),
                 slot_v.data_ptr(), slot_r.data_ptr(), _MAX_BLOCKS, stream)
    _build.check("getrf_leaf", err, "getrf_leaf launch")
    getrf_leaf.launches += 1
    strip.copy_(strip.index_select(0, pj))
    return strip, pj, piv


getrf_leaf.launches = 0


def getrf_leaf_plain(strip: torch.Tensor):
    """The kernel's step rule on tensors, in place; any float dtype.
    Returns (strip, pj, pivots) like getrf_leaf."""
    _check(strip)
    mm, ib = strip.shape
    t = strip
    dev = t.device
    done = torch.zeros(mm, dtype=torch.bool, device=dev)
    pj = np.arange(mm, dtype=np.int32)
    invp = np.arange(mm, dtype=np.int32)
    piv = np.zeros(ib, dtype=np.int32)
    for c in range(ib):
        col = t[:, c].clone()
        # a NaN ranks below every number, a done row below everything;
        # argmax returns the first (smallest) row among equal values
        cand = torch.where(torch.isnan(col), -0.5, col.abs())
        cand = torch.where(done, -1.0, cand)
        p = int(torch.argmax(cand))
        pivval = col[p]
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        act = ~done
        act[p] = False
        lvec = torch.where(act, col / safe, torch.zeros_like(col))
        t[:, c + 1:] -= lvec[:, None] * t[p, c + 1:][None, :]
        t[:, c] = torch.where(act, lvec, col)
        done[p] = True
        cur = int(invp[p])
        pj_c, pj_cur = int(pj[c]), int(pj[cur])
        pj[c], pj[cur] = pj_cur, pj_c
        invp[pj_c], invp[pj_cur] = cur, c
        piv[c] = cur
    pj_t = torch.from_numpy(pj).to(dev)
    strip.copy_(strip.index_select(0, pj_t))
    return strip, pj_t, torch.from_numpy(piv).to(dev)


# leaves that algs/lu.py sent to the plain version on request
# (CAPITAL_LU_LEAF=jax); a CPU tensor's plain run through getrf_leaf is
# not a fallback
getrf_leaf_plain.fallbacks = 0
