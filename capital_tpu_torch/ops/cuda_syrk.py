"""Triangle-aware Gram kernel G = A^T A from upper tiles only (counterpart
of capital_tpu/ops/pallas_syrk.py::syrk_upper).

On a CUDA tensor `syrk_upper` launches the hand-written kernels
(`csrc/syrk_upper.cu`); on a CPU tensor it runs `syrk_upper_plain`, which
repeats their schedule on tensors: upper output tiles, contraction in row
chunks of `mc`, the running sum folded into a second accumulator every 32
chunks (32 x 512 rows on the card, as on the TPU), and each entry with
row <= col mirrored below the diagonal, so G is bitwise symmetric.

At 'high' / 'default' the wrapper first packs A once into a K-major bf16
copy (`split_pack`, whose plain version is `split_pack_plain`): hi, and at
'high' lo, each n_pad x m_pad, so it allocates m_pad * n_pad * 2 bytes of
scratch a pass (m * n * 4 bytes at 'high'). The tensor cores then sum each
promotion interval of 128 contraction rows in a fresh accumulator that is
added to the running f32 sum.
"""

from __future__ import annotations

import ctypes

import torch

from capital_tpu_torch.ops import _build
from capital_tpu_torch.ops.cuda_dot import tile_dot_plain
from capital_tpu_torch.ops.cuda_trmm import _PREC_CODE, level_for, window
from capital_tpu_torch.ops.precision import HIGH, HIGHEST, split_f32

_T = 128    # the kernel's output tile side
_BK = 64    # the tensor-core kernel's contraction rows per stage
_MC = 512   # row chunk; the fold fires every _FOLD chunks
_FOLD = 32

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_SPLIT_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def split_shape(m: int, n: int) -> tuple[int, int]:
    """(n_pad, m_pad) of the packed copy: n to the tile, m to the stage."""
    return -(-n // _T) * _T, -(-m // _BK) * _BK


def split_pack_plain(a: torch.Tensor, level: str):
    """The split pass on tensors: (hi, lo) bf16, each (n_pad, m_pad) with
    hi[c, k] from A[k, c] and zeros in the padding. At 'high' hi is
    `split_f32`'s (RNE on the bit pattern) and lo = bf16(x - hi); otherwise
    hi = bf16(x) and lo is None."""
    m, n = a.shape
    n_pad, m_pad = split_shape(m, n)
    x = torch.zeros((n_pad, m_pad), dtype=torch.float32, device=a.device)
    x[:n, :m] = a.T.float()
    if level != HIGH or a.dtype == torch.bfloat16:
        return x.to(torch.bfloat16), None
    hi, lo = split_f32(x)
    return hi.to(torch.bfloat16), lo.to(torch.bfloat16)


def _check_input(av: torch.Tensor) -> None:
    if av.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"syrk_upper kernel takes f32/bf16, got {av.dtype}")
    if av.stride(1) != 1:
        raise ValueError("syrk_upper kernel needs a unit column stride")


def split_pack(a: torch.Tensor, level: str):
    """The split pass: (hi, lo) as `split_pack_plain` gives them. On a CUDA
    tensor the split kernel writes them as the two planes of one buffer
    (lo, where there is one, right after hi), as the product kernel reads
    them."""
    if not a.is_cuda:
        return split_pack_plain(a, level)
    _check_input(a)
    m, n = a.shape
    lo = level == HIGH and a.dtype == torch.float32
    buf = torch.empty((2 if lo else 1, *split_shape(m, n)),
                      dtype=torch.bfloat16, device=a.device)
    fn = _build.function("syrk_upper", "capital_syrk_split", _SPLIT_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(a.dtype == torch.bfloat16), int(lo), a.data_ptr(),
                 a.stride(0), m, n, buf.data_ptr(), stream)
    _build.check("syrk_upper", err, "syrk_upper split pass")
    return buf[0], buf[1] if lo else None


def syrk_upper(a: torch.Tensor, out_dtype=torch.float32, *,
               matmul_precision=None, a_window=None) -> torch.Tensor:
    """Full symmetric G = A^T A of A, or of its (r0, c0, h, w) window."""
    av = window(a, a_window)
    level = level_for(av.dtype, matmul_precision)
    if not av.is_cuda:
        return syrk_upper_plain(av, out_dtype, prec=level)
    _check_input(av)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"syrk_upper kernel writes f32/bf16, not {out_dtype}")
    m, n = av.shape
    g = torch.empty((n, n), dtype=out_dtype, device=av.device)
    hi = None if level == HIGHEST else split_pack(av, level)[0]
    fn = _build.function("syrk_upper", "capital_syrk_upper", _ARGTYPES)
    with torch.cuda.device(av.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(av.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), _PREC_CODE[level],
                 av.data_ptr(), av.stride(0), g.data_ptr(), g.stride(0),
                 m, n, None if hi is None else hi.data_ptr(), stream)
    _build.check("syrk_upper", err, "syrk_upper launch")
    syrk_upper.launches += 1
    return g


syrk_upper.launches = 0


def syrk_upper_plain(a: torch.Tensor, out_dtype=torch.float32, *,
                     prec=HIGHEST, t: int = _T, mc: int = _MC) -> torch.Tensor:
    """The kernel's schedule on tensors (one row panel of upper tiles at a
    time; each entry's arithmetic is the per-tile sum of the kernel)."""
    m, n = a.shape
    nc = -(-m // mc)
    g = torch.zeros((n, n), dtype=torch.float32, device=a.device)
    for i0 in range(0, n, t):
        acc = acc2 = None
        for c in range(nc):
            rows = slice(c * mc, (c + 1) * mc)
            p = tile_dot_plain(a[rows, i0:i0 + t], a[rows, i0:],
                               contract_dim0=True, prec=prec)
            acc = p if acc is None else acc + p
            if (c + 1) % _FOLD == 0 and c != nc - 1:
                acc2 = acc if acc2 is None else acc2 + acc
                acc = None
        g[i0:i0 + t, i0:] = acc if acc2 is None else acc2 + acc
    g = torch.triu(g) + torch.triu(g, 1).T
    return g.to(out_dtype)
