"""Triangle-aware Gram kernel G = A^T A from upper tiles only (counterpart
of capital_tpu/ops/pallas_syrk.py::syrk_upper).

On a CUDA tensor `syrk_upper` launches the hand-written kernels
(`csrc/syrk_upper.cu`); on a CPU tensor it runs `syrk_upper_plain`, which
repeats their schedule on tensors: upper output tiles, contraction in row
chunks of `mc`, the running sum folded into a second accumulator every 32
chunks (32 x 512 rows on the card, as on the TPU), and each entry with
row <= col mirrored below the diagonal, so G is bitwise symmetric.

At 'high' / 'default' the wrapper first packs A once into a K-major bf16
copy (`ops/cuda_pack.py::pack` along A's rows, the split pass): hi, and
at 'high' lo, each n_pad x m_pad, so it allocates m_pad * n_pad * 2
bytes of scratch a pass (m * n * 4 bytes at 'high'). The tensor cores then sum each
promotion interval of 128 contraction rows in a fresh accumulator that is
added to the running f32 sum.
"""

from __future__ import annotations

import ctypes

import torch

from capital_tpu_torch.ops import _build, cuda_pack
from capital_tpu_torch.ops.cuda_dot import tile_dot_plain
from capital_tpu_torch.ops.cuda_trmm import _PREC_CODE, level_for, window
from capital_tpu_torch.ops.precision import HIGHEST

_T = 128    # the kernel's output tile side
_MC = 512   # row chunk; the fold fires every _FOLD chunks
_FOLD = 32

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _check_input(av: torch.Tensor) -> None:
    if av.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"syrk_upper kernel takes f32/bf16, got {av.dtype}")
    if av.stride(1) != 1:
        raise ValueError("syrk_upper kernel needs a unit column stride")


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
    hi = None if level == HIGHEST else cuda_pack.pack(av, level)[0]
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
