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
two agree up to ties), a NaN below every number; the other not-done rows
get multipliers t / pivval (a zero pivot divides by 1) and a rank-1
update of the later columns, computed as a product followed by a
subtraction.

On a CUDA tensor a kernel of `csrc/getrf_leaf.cu` runs it (f32,
ib <= 128, any height, any row stride), by one of two routes that `plan`
picks from (mm, ib, the card's SM count, its shared memory per block)
before the launch:

  resident: the strip lives in shared memory across the grid, one
            cooperative CTA an SM, one exchange between the CTAs a column;
            the kernel writes the strip back swapped, so a call is one
            device launch. Every leaf of the LU paths takes it (132 CTAs
            hold ~58k rows at ib = 128);
  tall:     strips taller than that stay in global memory (one grid sync
            and two block reductions a column), and the wrapper gathers
            the strip by pj afterwards.

A launch that fails raises; it never switches route. On a CPU tensor
`getrf_leaf_plain` repeats the same step rule on tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from capital_tpu_torch.ops import _build

MAX_IB = 128      # the kernels' widest strip (the pivot row in shared memory)
_MAX_BLOCKS = 4096  # the tall route's candidate slots per parity

RES_THREADS = 512       # threads of a resident CTA
RES_MAX_BLOCKS = 160    # resident CTAs one warp polls (5 slots a lane)
RES_STATIC_SMEM = 2048  # bytes kept for the resident kernel's static arrays
# rows per CTA below which the resident route uses fewer CTAs
RES_MIN_ROWS = 32
_SLOT_WORDS = 4 + MAX_IB  # 8-byte words of a resident slot: head, row

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_TALL_ARGS = [_PTR, ctypes.c_longlong, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
              _PTR, _PTR, _INT, _PTR]
_RESIDENT_ARGS = [_PTR, ctypes.c_longlong, _INT, _INT, _INT, _INT, _INT,
                  _PTR, _PTR, _PTR, _PTR]


class Plan(NamedTuple):
    """How one strip is launched: the route, and for the resident route
    its CTAs, rows a CTA, threads a row, row pitch (floats) and dynamic
    shared memory (bytes)."""

    route: str
    blocks: int = 0
    rows_per: int = 0
    split: int = 0
    pitch: int = 0
    smem: int = 0


def plan(mm: int, ib: int, sms: int, smem_per_block: int,
         min_rows: int = RES_MIN_ROWS) -> Plan:
    """The route of an (mm, ib) strip on a card with `sms` SMs and
    `smem_per_block` bytes of opt-in shared memory a block.

    Resident when the rows of one CTA an SM fit its shared memory: a CTA
    takes ceil(mm / min(sms, RES_MAX_BLOCKS)) rows, but at least
    `min_rows` (short strips run on fewer CTAs). `split` threads share a
    row (the largest power of two <= 32 that still gives every row a
    thread group), and the row pitch is the smallest >= ib that is split
    mod 32 words, so the threads of a warp touch distinct banks. A row
    costs pitch floats plus its position."""
    rows_per = max(-(-mm // min(sms, RES_MAX_BLOCKS)), min(mm, min_rows))
    split = 1
    while split < 32 and RES_THREADS // (2 * split) >= rows_per:
        split *= 2
    pitch = ib + (split - ib) % 32
    smem = rows_per * (4 * pitch + 4)
    if smem + RES_STATIC_SMEM > smem_per_block:
        return Plan("tall")
    return Plan("resident", -(-mm // rows_per), rows_per, split, pitch, smem)


@functools.lru_cache(maxsize=None)
def limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory per block in bytes) of card `index`."""
    fn = _build.function("getrf_leaf", "capital_getrf_limits", [_PTR, _PTR])
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = fn(ctypes.addressof(sms), ctypes.addressof(smem))
    _build.check("getrf_leaf", err, "getrf_leaf device limits")
    return sms.value, smem.value


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
    return launch(strip, plan(mm, ib, *limits(strip.device.index)))


def launch(strip: torch.Tensor, how: Plan):
    """Run the kernel of route `how.route` on a checked CUDA strip."""
    mm, ib = strip.shape
    dev = strip.device
    pj = torch.empty(mm, dtype=torch.int32, device=dev)
    piv = torch.empty(ib, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if how.route == "resident":
            slots = torch.empty(2 * how.blocks * _SLOT_WORDS,
                                dtype=torch.int64, device=dev)
            fn = _build.function("getrf_leaf", "capital_getrf_resident",
                                 _RESIDENT_ARGS)
            err = fn(strip.data_ptr(), strip.stride(0), mm, ib, how.rows_per,
                     how.split, how.pitch, pj.data_ptr(), piv.data_ptr(),
                     slots.data_ptr(), stream)
        else:
            invp = torch.empty(mm, dtype=torch.int32, device=dev)
            done = torch.empty(mm, dtype=torch.int32, device=dev)
            slot_v = torch.empty(2 * _MAX_BLOCKS, dtype=torch.float32,
                                 device=dev)
            slot_r = torch.empty(2 * _MAX_BLOCKS, dtype=torch.int32,
                                 device=dev)
            fn = _build.function("getrf_leaf", "capital_getrf_tall",
                                 _TALL_ARGS)
            err = fn(strip.data_ptr(), strip.stride(0), mm, ib,
                     pj.data_ptr(), invp.data_ptr(), done.data_ptr(),
                     piv.data_ptr(), slot_v.data_ptr(), slot_r.data_ptr(),
                     _MAX_BLOCKS, stream)
    _build.check("getrf_leaf", err, f"getrf_leaf {how.route} launch")
    getrf_leaf.launches += 1
    getrf_leaf.by_route[how.route] += 1
    if how.route == "tall":
        strip.copy_(strip.index_select(0, pj))
    return strip, pj, piv


getrf_leaf.launches = 0
getrf_leaf.by_route = {"resident": 0, "tall": 0}


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
