"""SYRK in this checkout against another checkout, on one card.

    git archive <commit> | tar -x -C DIR
    python -m capital_tpu_torch.bench.syrk_ab --other DIR
    python -m capital_tpu_torch.bench.syrk_ab --other DIR --precision highest

Builds each tree's `csrc/syrk_upper.cu` with this checkout's nvcc flags,
prints each product kernel's SASS counts (instructions, HGMMA, local-memory
loads and stores; `cuobjdump`), then alternates the two trees (A B B A,
then B A A B, ...), each launch timed with CUDA events.

'high' (default): an n x n window of an n x 2n workspace, the split pass
(`capital_pack` along the rows, or the older `capital_syrk_split`) and the
product (`capital_syrk_upper`); the packed copies and G must be bitwise
equal between the trees.

'highest': the FFMA route at each of `--shapes` (m x n; the 16384 x 16384
one a window of a 16384 x 32768 workspace), the launch with the row splits
each tree takes (1 in a tree without them: `capital_syrk_slots` absent).
Per shape: the splits, whether G is bitwise equal between the trees (it
must be where this tree takes one split, or splits of one fold each),
whether two calls of this tree give the same G bit for bit, and this
tree's G against `syrk_upper_plain(..., splits=s)` (relative Frobenius).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from capital_tpu_torch.ops import _build, cuda_syrk

_V, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PREC = {"highest": 0, "high": 1}
_HIGHEST_SHAPES = ("16384x16384", "1048576x1024", "262144x2048",
                   "262144x144")


def _load(src: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    split = hasattr(lib, "capital_syrk_slots")
    lib.capital_syrk_upper.argtypes = [_I, _I, _I, _V, _LL, _V, _LL, _I, _I,
                                       *([_I] if split else []), _V, _V]
    if split:
        lib.capital_syrk_slots.argtypes = [_I, _I, _V]
    if hasattr(lib, "capital_pack"):
        lib.capital_pack.argtypes = [_I, _I, _I, _I, _V, _LL, _I, _I, _V, _V]
    else:
        lib.capital_syrk_split.argtypes = [_I, _I, _V, _LL, _I, _I, _V, _V]
    return lib


def _sass(so: Path, kind: str) -> dict:
    """{kernel: (instructions, HGMMA, local ld/st)} of the kernels whose
    names hold `kind`."""
    out = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    fn, counts = None, {}
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and kind in fn and "/*" in line and ";" in line:
            c = counts.setdefault(fn, [0, 0, 0])
            c[0] += 1
            c[1] += "HGMMA" in line
            c[2] += "LDL" in line or "STL" in line
    return counts


def _per_launch(fn, reps: int) -> list:
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]


def _alternate(run, tags, rounds: int, reps: int, times: dict) -> None:
    """times[tag] += per-launch ms of run(tag), A B B A then B A A B..."""
    a, b = tags
    for rnd in range(rounds):
        for tag in (a, b, b, a) if rnd % 2 == 0 else (b, a, a, b):
            times[tag] += _per_launch(lambda: run(tag), reps)


def _report(tag: str, root: Path, what: str, t: list) -> None:
    print(f"{tag} ({root}) {what}: {len(t)} launches, ms min {min(t):.3f} "
          f"median {statistics.median(t):.3f} max {max(t):.3f}")


def _high(libs: dict, trees: dict, args) -> None:
    n = args.n
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = (torch.rand((n, 2 * n), generator=gen, device="cuda") - 0.5)[:, n:]
    scratch = torch.empty((2, n, n), dtype=torch.bfloat16, device="cuda")
    g = torch.empty((n, n), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def split(tag):
        lib = libs[tag]
        if hasattr(lib, "capital_pack"):
            err = lib.capital_pack(0, 1, 1, 0, a.data_ptr(), a.stride(0), n,
                                   n, scratch.data_ptr(), stream)
        else:
            err = lib.capital_syrk_split(0, 1, a.data_ptr(), a.stride(0), n,
                                         n, scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{tag} split pass: CUDA error {err}")

    def prod(tag):
        lib = libs[tag]
        ends = ((1,) if hasattr(lib, "capital_syrk_slots") else ()) + (
            scratch.data_ptr(), stream)
        err = lib.capital_syrk_upper(0, 0, _PREC["high"], a.data_ptr(),
                                     a.stride(0), g.data_ptr(), g.stride(0),
                                     n, n, *ends)
        if err:
            raise RuntimeError(f"{tag} product: CUDA error {err}")

    outs = {}
    for tag in libs:
        split(tag)
        packed = scratch.clone()
        prod(tag)
        torch.cuda.synchronize()
        outs[tag] = (packed.view(torch.int16), g.clone())
    print("packed copies bitwise equal:",
          torch.equal(outs["A"][0], outs["B"][0]))
    print("G bitwise equal:", torch.equal(outs["A"][1], outs["B"][1]))
    del outs

    times = {tag: {"split": [], "product": []} for tag in libs}
    for rnd in range(args.rounds):
        for tag in ("A", "B", "B", "A") if rnd % 2 == 0 else ("B", "A", "A",
                                                              "B"):
            times[tag]["split"] += _per_launch(lambda: split(tag), args.reps)
            split(tag)
            times[tag]["product"] += _per_launch(lambda: prod(tag),
                                                 args.reps)
    for tag, root in trees.items():
        for what, t in times[tag].items():
            _report(tag, root, what, t)


def _highest(libs: dict, trees: dict, args) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for shape in args.shapes:
        m, n = (int(x) for x in shape.split("x"))
        if m == n:  # cholinv's top-level Schur: a window of a workspace
            a = (torch.rand((m, 2 * n), generator=gen, device="cuda")
                 - 0.5)[:, n:]
        else:
            a = torch.rand((m, n), generator=gen, device="cuda") - 0.5
        g = torch.empty((n, n), device="cuda")
        splits, parts = {}, {}
        for tag, lib in libs.items():
            if not hasattr(lib, "capital_syrk_slots"):
                splits[tag], parts[tag] = 1, None
                continue
            slots = ctypes.c_int()
            err = lib.capital_syrk_slots(0, m, ctypes.addressof(slots))
            if err:
                raise RuntimeError(f"{tag} slots: CUDA error {err}")
            s = cuda_syrk.split_count(m, n, slots.value)
            splits[tag] = s
            parts[tag] = (torch.empty(cuda_syrk.split_scratch(n, s),
                                      device="cuda") if s > 1 else None)

        def prod(tag):
            lib, part = libs[tag], parts[tag]
            ptr = None if part is None else part.data_ptr()
            ends = (((splits[tag],) if hasattr(lib, "capital_syrk_slots")
                     else ()) + (ptr, stream))
            err = lib.capital_syrk_upper(0, 0, _PREC["highest"], a.data_ptr(),
                                         a.stride(0), g.data_ptr(),
                                         g.stride(0), m, n, *ends)
            if err:
                raise RuntimeError(f"{tag} product: CUDA error {err}")

        outs = {}
        for tag in ("A", "B", "A"):
            prod(tag)
            torch.cuda.synchronize()
            outs.setdefault(tag, []).append(g.clone())
        want = cuda_syrk.syrk_upper_plain(a, splits=splits["A"])
        d = outs["A"][0].double() - want.double()
        rel = float(torch.linalg.norm(d) / torch.linalg.norm(want.double()))
        print(f"[{shape}] splits A {splits['A']} B {splits['B']}; G bitwise "
              f"equal between the trees: "
              f"{torch.equal(outs['A'][0], outs['B'][0])}; A's two calls "
              f"bitwise equal: {torch.equal(outs['A'][0], outs['A'][1])}; "
              f"A bitwise symmetric: "
              f"{torch.equal(outs['A'][0], outs['A'][0].T)}; A against "
              f"syrk_upper_plain(splits={splits['A']}): rel_err {rel:.3e}",
              flush=True)
        del outs, want, d
        times = {tag: [] for tag in libs}
        _alternate(prod, ("A", "B"), args.rounds, args.reps, times)
        for tag, root in trees.items():
            _report(tag, root, f"[{shape}] product (splits {splits[tag]})",
                    times[tag])
        del a, g, parts
        torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="root of the other tree")
    p.add_argument("--precision", choices=tuple(_PREC), default="high")
    p.add_argument("--n", type=int, default=16384, help="'high': the side")
    p.add_argument("--shapes", nargs="+", default=_HIGHEST_SHAPES,
                   help="'highest': m x n operands, e.g. 1048576x1024")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("syrk_ab needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    rel = Path("capital_tpu_torch/csrc/syrk_upper.cu")
    tmp = Path(tempfile.mkdtemp())
    trees = {"A": Path.cwd(), "B": Path(args.other)}
    kind = "wgmma" if args.precision == "high" else "syrk_"
    libs = {}
    for tag, root in trees.items():
        libs[tag] = _load(root / rel, tmp / f"syrk_{tag}.so")
        for k, (ins, hg, loc) in _sass(tmp / f"syrk_{tag}.so", kind).items():
            print(f"{tag} {k}: instructions {ins} HGMMA {hg} local ld/st "
                  f"{loc}")
    (_high if args.precision == "high" else _highest)(libs, trees, args)


if __name__ == "__main__":
    main()
