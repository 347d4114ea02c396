"""Triangle-aware Gram kernel G = A^T A from upper tiles only (counterpart
of capital_tpu/ops/pallas_syrk.py::syrk_upper).

On a CUDA tensor `syrk_upper` launches the hand-written kernels
(`csrc/syrk_upper.cu`); on a CPU tensor it runs `syrk_upper_plain` (one
row split), which repeats their schedule on tensors: upper output tiles,
contraction in row chunks of `mc`, the running sum folded into a second
accumulator every 32 chunks (32 x 512 rows on the card, as on the TPU),
and each entry with row <= col mirrored below the diagonal, so G is
bitwise symmetric.

At 'high' / 'default' the wrapper first packs A once into a K-major bf16
copy (`ops/cuda_pack.py::pack` along A's rows, the split pass): hi, and
at 'high' lo, each n_pad x m_pad, so it allocates m_pad * n_pad * 2
bytes of scratch a pass (m * n * 4 bytes at 'high'). The tensor cores then sum each
promotion interval of 128 contraction rows in a fresh accumulator that is
added to the running f32 sum. At 'highest' the FFMA kernel sums each
chunk of 512 rows in a fresh accumulator added to the running sum at the
chunk's end, as the plain version sums each chunk in one tile_dot.

Where the upper tiles alone leave the card idle (a tall, narrow A), the
'highest' launch also splits A's rows: `split_count` picks the count from
the tiles, the CTAs the card holds at once and m; each split sums whole
folds (whole chunks where m <= 32 x 512) as above, and the partial tiles,
splits x tiles x 128^2 floats of scratch, are added in split order by a
second kernel. `syrk_upper_plain(..., splits=s)` is that schedule.
"""

from __future__ import annotations

import ctypes
import functools

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
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
_MAX_SPLITS = 65535  # gridDim.y


def _unit(m: int, mc: int) -> int:
    """Rows a split takes a whole number of: a fold, or a chunk where the
    contraction has at most one fold."""
    return mc * _FOLD if m > mc * _FOLD else mc


def _tiles(n: int, t: int = _T) -> int:
    """Upper output tiles of an n x n G."""
    nt = -(-n // t)
    return nt * (nt + 1) // 2


def split_scratch(n: int, splits: int) -> int:
    """Floats of the partial tiles a launch with `splits` > 1 writes."""
    return splits * _tiles(n) * _T * _T


def split_rows(m: int, splits: int, mc: int = _MC) -> int:
    """Rows of each of `splits` row splits of an m-row contraction (the
    last takes what is left)."""
    unit = _unit(m, mc)
    units = -(-m // unit)
    return -(-units // splits) * unit


@functools.lru_cache(maxsize=4096)
def split_count(m: int, n: int, slots: int, t: int = _T,
                mc: int = _MC) -> int:
    """Row splits of the 'highest' Gram of an m x n A on a card that holds
    `slots` CTAs at once. The makespan in whole waves, ceil(tiles * s /
    slots) waves of ceil(units / s) folds (or chunks) each, is shortest for
    some s; this is the fewest splits within 1/32 of that, since each split
    sends every tile's partial through memory once more. Where the tiles
    fill the card's waves, that is 1."""
    tiles = _tiles(n, t)
    units = -(-m // _unit(m, mc))
    spans = [-(-tiles * s // slots) * -(-units // s)
             for s in range(1, min(units, _MAX_SPLITS) + 1)]
    best = min(spans)
    return next(s for s, span in enumerate(spans, 1) if 32 * span <= 33 * best)


def splits_for(a: torch.Tensor, out_dtype=torch.float32,
               level=HIGHEST) -> int:
    """Row splits of syrk_upper's launch for the CUDA tensor `a` (its
    window) on its card: `split_count` at 'highest', else 1."""
    if level != HIGHEST:
        return 1
    m, n = a.shape
    return split_count(m, n, _slots(a.device.index,
                                    out_dtype == torch.bfloat16, m))


@functools.lru_cache(maxsize=256)
def _slots(index: int, bf16_out: bool, m: int) -> int:
    """CTAs of the 'highest' kernel for m rows that card `index` holds at
    once (its SMs times the kernel's occupancy)."""
    fn = _build.function("syrk_upper", "capital_syrk_slots",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    slots = ctypes.c_int()
    with torch.cuda.device(index):
        err = fn(int(bf16_out), m, ctypes.addressof(slots))
    _build.check("syrk_upper", err, "syrk_upper occupancy")
    return slots.value


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
    splits = splits_for(av, out_dtype, level)
    if level != HIGHEST:
        scratch = cuda_pack.pack(av, level)[0]
    elif splits > 1:
        scratch = torch.empty(split_scratch(n, splits), dtype=torch.float32,
                              device=av.device)
    else:
        scratch = None
    fn = _build.function("syrk_upper", "capital_syrk_upper", _ARGTYPES)
    with torch.cuda.device(av.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(int(av.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), _PREC_CODE[level],
                 av.data_ptr(), av.stride(0), g.data_ptr(), g.stride(0),
                 m, n, splits, None if scratch is None else scratch.data_ptr(),
                 stream)
    _build.check("syrk_upper", err, "syrk_upper launch")
    syrk_upper.launches += 1
    by_route = syrk_upper.by_route
    by_route["split" if splits > 1 else "tiles"] += 1
    by_route["max_splits"] = max(by_route["max_splits"], splits)
    return g


syrk_upper.launches = 0
# launches without a row split and with one, and the most splits of any
syrk_upper.by_route = {"tiles": 0, "split": 0, "max_splits": 0}


def syrk_upper_plain(a: torch.Tensor, out_dtype=torch.float32, *,
                     prec=HIGHEST, t: int = _T, mc: int = _MC,
                     splits: int = 1) -> torch.Tensor:
    """The kernel's schedule on tensors (one row panel of upper tiles at a
    time; each entry's arithmetic is the per-tile sum of the kernel): each
    of `splits` row ranges (`split_rows`) summed apart, then the partials
    added in order."""
    m, n = a.shape
    rows = split_rows(m, splits, mc)
    g = torch.zeros((n, n), dtype=torch.float32, device=a.device)
    for i0 in range(0, n, t):
        panel = None
        for r0 in range(0, m, rows):
            p = _panel_sum(a[r0:r0 + rows], i0, prec, t, mc)
            panel = p if panel is None else panel + p
        g[i0:i0 + t, i0:] = panel
    g = torch.triu(g) + torch.triu(g, 1).T
    return g.to(out_dtype)


def _panel_sum(a: torch.Tensor, i0: int, prec, t: int,
               mc: int) -> torch.Tensor:
    """a[:, i0:i0 + t]^T a[:, i0:]: each chunk of mc rows in one tile_dot,
    added into the running sum, folded into a second one every _FOLD
    chunks."""
    nc = -(-a.shape[0] // mc)
    acc = acc2 = None
    for c in range(nc):
        rows = slice(c * mc, (c + 1) * mc)
        p = tile_dot_plain(a[rows, i0:i0 + t], a[rows, i0:],
                           contract_dim0=True, prec=prec)
        acc = p if acc is None else acc + p
        if (c + 1) % _FOLD == 0 and c != nc - 1:
            acc2 = acc if acc2 is None else acc2 + acc
            acc = None
    return acc if acc2 is None else acc2 + acc
