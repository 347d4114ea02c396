"""The pack pass of the Hopper product kernels (SYRK, TRMM): one operand
read once and written as the zero-padded copy the products read
(`csrc/hopper_mma.cuh`, C entry `capital_pack`).

The operand X (o x k: o output rows or columns, k contraction) is held by
its source array either with the contraction along the source's rows
(X[o, k] = a[k, o], `along_rows`: SYRK's A, TRMM's B on side L, Uᵀ) or
along its columns (X[o, k] = a[o, k]). With `upper`, the entries below
the source's diagonal (row > col in its own indices) are written as
zeros: TRMM's triangle mask. o is padded to 128 (the output tile), k to
64 (a tensor-core stage), with zeros.

  'high', f32    hi and lo planes, bf16, each [o_pad, k_pad] (K-major);
                 hi = `split_f32`'s (RNE on the bit pattern), lo =
                 bf16(x - hi)
  'default', or a bf16 operand at any level
                 one bf16 plane, [o_pad, k_pad]
  'highest', f32 one f32 plane laid out [k_pad, o_pad], the slabs the
                 FFMA kernels load with 16-byte copies
"""

from __future__ import annotations

import ctypes

import torch

from capital_tpu_torch.ops import _build
from capital_tpu_torch.ops.precision import HIGH, HIGHEST, split_f32

_T = 128   # outer padding: the output tile side
_BK = 64   # contraction padding: one tensor-core stage
HI, HI_LO, F32 = 0, 1, 2  # csrc/hopper_mma.cuh PackMode

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def pack_shape(o: int, k: int) -> tuple[int, int]:
    """(o_pad, k_pad): o to the tile, k to the stage."""
    return -(-o // _T) * _T, -(-k // _BK) * _BK


def mode(level: str, dtype: torch.dtype) -> int:
    """The pack a product at `level` reads for operands of `dtype`."""
    if dtype == torch.bfloat16:
        return HI
    return {HIGHEST: F32, HIGH: HI_LO}.get(level, HI)


def nbytes(o: int, k: int, pack_mode: int) -> int:
    """Bytes of one operand's pack."""
    o_pad, k_pad = pack_shape(o, k)
    return o_pad * k_pad * (4 if pack_mode == F32 else
                            2 * (2 if pack_mode == HI_LO else 1))


def pack_plain(a: torch.Tensor, level: str, *, along_rows: bool = True,
               upper: bool = False):
    """The pack pass on tensors: (hi, lo) with lo None where the mode has
    none; at 'highest' (f32) hi is the f32 [k_pad, o_pad] plane."""
    x = torch.triu(a) if upper else a
    x = (x.T if along_rows else x).float()
    o, k = x.shape
    o_pad, k_pad = pack_shape(o, k)
    p = torch.zeros((o_pad, k_pad), dtype=torch.float32, device=a.device)
    p[:o, :k] = x
    m = mode(level, a.dtype)
    if m == F32:
        return p.T.contiguous(), None
    if m == HI:
        return p.to(torch.bfloat16), None
    hi, lo = split_f32(p)
    return hi.to(torch.bfloat16), lo.to(torch.bfloat16)


def pack(a: torch.Tensor, level: str, *, along_rows: bool = True,
         upper: bool = False):
    """The pack pass: (hi, lo) as `pack_plain` gives them. On a CUDA tensor
    the pack kernel writes them as the planes of one buffer, lo right after
    hi, as the products read them."""
    if not a.is_cuda:
        return pack_plain(a, level, along_rows=along_rows, upper=upper)
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack takes f32/bf16, got {a.dtype}")
    if a.stride(1) != 1:
        raise ValueError("pack needs a unit column stride")
    m = mode(level, a.dtype)
    rows, cols = a.shape
    o_pad, k_pad = pack_shape(cols, rows) if along_rows else pack_shape(
        rows, cols)
    if m == F32:
        buf = torch.empty((1, k_pad, o_pad), dtype=torch.float32,
                          device=a.device)
    else:
        buf = torch.empty((2 if m == HI_LO else 1, o_pad, k_pad),
                          dtype=torch.bfloat16, device=a.device)
    # every product library carries the pack (csrc/hopper_mma.cuh)
    fn = _build.function("trmm_upper", "capital_pack", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(a.dtype == torch.bfloat16), m, int(along_rows),
                 int(upper), a.data_ptr(), a.stride(0), rows, cols,
                 buf.data_ptr(), stream)
    _build.check("trmm_upper", err, "pack pass")
    return buf[0], buf[1] if m == HI_LO else None
