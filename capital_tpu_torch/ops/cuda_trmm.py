"""Triangle-aware TRMM: multiply by upper-triangular U over the nonzero
tiles only (counterpart of capital_tpu/ops/pallas_trmm.py::trmm_upper).

  side='L'             C = triu(U) @ B        pairs k >= i
  side='L', trans_a    C = triu(U)^T @ B      pairs k <= i  (cholinv's TRSM)
  side='R'             C = B @ triu(U)        pairs k <= j  (inverse assembly)
  side='R', trans_a    C = B @ triu(U)^T      pairs k >= j  (QDWH)

On a CUDA tensor `trmm_upper` launches the hand-written kernels
(`csrc/trmm_upper.cu`): the pack pass (`ops/cuda_pack.py`) writes both
operands into scratch the wrapper allocates, U masked to its triangle,
and the product reads the packs (`wgmma` over bf16 packs at 'high' /
'default', FFMA over f32 packs at 'highest'). The scratch is
(o_pad_A + o_pad_B) * k_pad elements a plane, freed when the call
returns: (n^2 + n*m) * 4 bytes at 'high' and 'highest' for 128-aligned
shapes, half that at 'default'. On a CPU tensor it runs
`trmm_upper_plain`, which repeats the kernel's schedule on tensors: the
same output tiles, the same k range per tile, the diagonal tile masked,
each 128-deep k tile summed on its own (the kernel's promotion interval)
through `tile_dot_plain`. Windows are strided views handed to the kernel
as pointer + leading dimension, never copied.
"""

from __future__ import annotations

import ctypes

import torch

from capital_tpu_torch.ops import _build, cuda_pack
from capital_tpu_torch.ops.cuda_dot import tile_dot_plain
from capital_tpu_torch.ops.precision import (DEFAULT, HIGH, HIGHEST,
                                             canonicalize, prec)

_T = 128  # the kernel's output tile side
_PREC_CODE = {HIGHEST: 0, HIGH: 1, DEFAULT: 2}
CASES = ("L", "L,trans", "R", "R,trans")

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_void_p]


def window(x: torch.Tensor, win) -> torch.Tensor:
    """(r0, c0, h, w) window of x as a view (no copy)."""
    if win is None:
        return x
    r0, c0, h, w = win
    if r0 + h > x.shape[0] or c0 + w > x.shape[1]:
        raise ValueError(f"window {win} outside a {tuple(x.shape)} array")
    return x[r0:r0 + h, c0:c0 + w]


def level_for(dtype: torch.dtype, matmul_precision) -> str:
    """Precision level a kernel runs: bf16 inputs always one pass."""
    if dtype == torch.bfloat16:
        return DEFAULT
    return canonicalize(matmul_precision if matmul_precision is not None
                        else prec())


def trmm_upper(u: torch.Tensor, b: torch.Tensor, *, side: str = "L",
               trans_a: bool = False, alpha: float = 1.0,
               matmul_precision=None, u_window=None,
               b_window=None) -> torch.Tensor:
    """alpha * op(triu(U)) @ B (side='L') or alpha * B @ op(triu(U))
    (side='R'). u_window=(r0, c0, n) / b_window=(r0, c0, h, w) select
    windows of larger arrays. Returns a new tensor of B's dtype."""
    uv = window(u, None if u_window is None
                else (u_window[0], u_window[1], u_window[2], u_window[2]))
    bv = window(b, b_window)
    n = uv.shape[0]
    if uv.shape[1] != n:
        raise ValueError(f"U must be square, got {tuple(uv.shape)}")
    if bv.shape[0 if side == "L" else 1] != n:
        raise ValueError(f"B {tuple(bv.shape)} does not match U ({n}) on "
                         f"side {side!r}")
    level = level_for(bv.dtype, matmul_precision)
    if not bv.is_cuda:
        return trmm_upper_plain(uv, bv, side=side, trans_a=trans_a,
                                alpha=alpha, prec=level)
    if uv.dtype != bv.dtype or bv.dtype not in (torch.float32,
                                                 torch.bfloat16):
        raise TypeError(f"trmm_upper kernel takes f32 or bf16 operands of "
                        f"one dtype, got {uv.dtype} and {bv.dtype}")
    if uv.device != bv.device or uv.stride(1) != 1 or bv.stride(1) != 1:
        raise ValueError("trmm_upper kernel needs operands on one device "
                         "with unit column stride")
    m = bv.shape[1] if side == "L" else bv.shape[0]
    out = torch.empty(bv.shape, dtype=bv.dtype, device=bv.device)
    scratch = torch.empty(scratch_bytes(n, m, level, bv.dtype),
                          dtype=torch.uint8, device=bv.device)
    fn = _build.function("trmm_upper", "capital_trmm_upper", _ARGTYPES)
    with torch.cuda.device(bv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(bv.dtype == torch.bfloat16), _PREC_CODE[level],
                 int(side == "R"), int(trans_a), uv.data_ptr(), uv.stride(0),
                 bv.data_ptr(), bv.stride(0), out.data_ptr(), out.stride(0),
                 n, m, float(alpha), scratch.data_ptr(), stream)
    _build.check("trmm_upper", err, "trmm_upper launch")
    trmm_upper.launches += 1
    trmm_upper.by_case[CASES[2 * (side == "R") + bool(trans_a)]] += 1
    return out


trmm_upper.launches = 0
trmm_upper.by_case = dict.fromkeys(CASES, 0)


def scratch_bytes(n: int, m: int, level: str, dtype: torch.dtype) -> int:
    """Bytes of the two packs a call on U (n x n) and B (n x m or m x n)
    needs: one operand is n x n-sized (o = n), the other o = m, and both
    contract over k = n, whatever the side."""
    pm = cuda_pack.mode(level, dtype)
    return cuda_pack.nbytes(n, n, pm) + cuda_pack.nbytes(m, n, pm)


def trmm_upper_plain(u: torch.Tensor, b: torch.Tensor, *, side: str = "L",
                     trans_a: bool = False, alpha: float = 1.0,
                     prec=HIGHEST, t: int = _T) -> torch.Tensor:
    """The kernel's schedule on tensors: for each output tile o, sum
    tile_dot over the k tiles inside the triangle, the diagonal tile
    masked with triu."""
    n = u.shape[0]
    nt = -(-n // t)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    k_ge_o = (side == "L") != bool(trans_a)  # cases L and R,trans
    for o in range(nt):
        acc = None
        for k in (range(o, nt) if k_ge_o else range(o + 1)):
            so, sk = slice(o * t, (o + 1) * t), slice(k * t, (k + 1) * t)
            if side == "L":
                tile = u[so, sk] if not trans_a else u[sk, so]
                if k == o:
                    tile = torch.triu(tile)
                p = tile_dot_plain(tile, b[sk, :], contract_dim0=trans_a,
                                   prec=prec)
            else:
                tile = u[sk, so] if not trans_a else u[so, sk]
                if k == o:
                    tile = torch.triu(tile)
                p = tile_dot_plain(b[:, sk], tile.T if trans_a else tile,
                                   prec=prec)
            acc = p if acc is None else acc + p
        acc = alpha * acc if alpha != 1.0 else acc
        if side == "L":
            out[o * t:(o + 1) * t, :] = acc.to(b.dtype)
        else:
            out[:, o * t:(o + 1) * t] = acc.to(b.dtype)
    return out
