"""SYRK at 'high' in this checkout against another checkout, on one card.

    git archive <commit> | tar -x -C DIR
    python -m capital_tpu_torch.bench.syrk_ab --other DIR

Builds each tree's `csrc/syrk_upper.cu` with this checkout's nvcc flags,
prints each `wgmma` kernel's SASS counts (instructions, HGMMA, local-memory
loads and stores; `cuobjdump`), then alternates the two trees (A B B A,
then B A A B, ...) on an n x n window of an n x 2n workspace: the split
pass (`capital_pack` along the rows, or the older `capital_syrk_split`)
and the product (`capital_syrk_upper`), each launch timed with CUDA
events. The packed copies and G must be bitwise equal between the trees.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from capital_tpu_torch.ops import _build

_V, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _load(src: Path, out: Path) -> ctypes.CDLL:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.capital_syrk_upper.argtypes = [_I, _I, _I, _V, _LL, _V, _LL, _I, _I,
                                       _V, _V]
    if hasattr(lib, "capital_pack"):
        lib.capital_pack.argtypes = [_I, _I, _I, _I, _V, _LL, _I, _I, _V, _V]
    else:
        lib.capital_syrk_split.argtypes = [_I, _I, _V, _LL, _I, _I, _V, _V]
    return lib


def _sass(so: Path) -> dict:
    """{kernel: (instructions, HGMMA, local ld/st)} of the wgmma kernels."""
    out = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    fn, counts = None, {}
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "wgmma" in fn and "/*" in line and ";" in line:
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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="root of the other tree")
    p.add_argument("--n", type=int, default=16384)
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
    libs = {}
    for tag, root in trees.items():
        libs[tag] = _load(root / rel, tmp / f"syrk_{tag}.so")
        for k, (ins, hg, loc) in _sass(tmp / f"syrk_{tag}.so").items():
            print(f"{tag} {k}: instructions {ins} HGMMA {hg} local ld/st "
                  f"{loc}")

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
        err = libs[tag].capital_syrk_upper(0, 0, 1, a.data_ptr(), a.stride(0),
                                           g.data_ptr(), g.stride(0), n, n,
                                           scratch.data_ptr(), stream)
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
            print(f"{tag} ({root}) {what}: {len(t)} launches, ms min "
                  f"{min(t):.3f} median {statistics.median(t):.3f} max "
                  f"{max(t):.3f}")


if __name__ == "__main__":
    main()
