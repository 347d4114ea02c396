"""Which of the collectives the SUMMA engine and darray's windows call
a backend takes, on which device: a (c, d, d) DeviceMesh over the ranks,
then on it all_gather_into_tensor ('x'), all_reduce ('z'),
reduce_scatter_tensor ('y'), batch_isend_irecv between partner ranks
and an uneven all_to_all_single ('x'), each checked against its
expected values. One JSON line a rank.

    python -m capital_tpu_torch.bench.mesh_probe      # NCCL, a rank a card
    python -m capital_tpu_torch.bench.mesh_probe --ranks 8 \
        --device cuda:0 --backend gloo
    python -m capital_tpu_torch.bench.mesh_probe --ranks 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.distributed as dist

from capital_tpu_torch.parallel import launch


def _check(name: str, fn, out: dict) -> None:
    try:
        ok = fn()
        out[name] = "ok" if ok else "wrong values"
    except Exception as exc:  # noqa: BLE001 - the probe reports each error
        out[name] = f"{type(exc).__name__}: {exc}"[:400]


def probe(shape: tuple) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = launch.world_device()
    out = {"rank": rank, "world": world, "device": str(dev),
           "backend": dist.get_backend(), "torch": torch.__version__}
    try:
        mesh = DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                          mesh_dim_names=("z", "y", "x"))
        out["mesh"] = "ok"
    except Exception as exc:  # noqa: BLE001
        out["mesh"] = f"{type(exc).__name__}: {exc}"[:400]
        return out
    gx, gy, gz = (mesh.get_group(a) for a in ("x", "y", "z"))
    sx, sy = dist.get_world_size(gx), dist.get_world_size(gy)
    mine = torch.full((4, 3), float(rank), device=dev)

    def gather():
        buf = torch.empty((4 * sx, 3), device=dev)
        dist.all_gather_into_tensor(buf, mine, group=gx)
        want = sorted(dist.get_process_group_ranks(gx))
        return bool(torch.equal(buf[::4, 0].cpu(), torch.tensor(
            want, dtype=torch.float32)))

    def reduce():
        x = mine.clone()
        dist.all_reduce(x, group=gz)
        want = float(sum(dist.get_process_group_ranks(gz)))
        return bool((x == want).all())

    def scatter():
        src = torch.arange(4 * sy * 3, dtype=torch.float32,
                           device=dev).reshape(4 * sy, 3)
        dst = torch.empty((4, 3), device=dev)
        dist.reduce_scatter_tensor(dst, src, group=gy)
        i = dist.get_group_rank(gy, rank)
        return bool(torch.equal(dst, src[4 * i:4 * (i + 1)] * sy))

    def p2p():
        if world == 1:
            return True  # no partner; the engine copies pairs to itself
        peer = rank ^ 1
        got = torch.empty_like(mine)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, mine, peer),
            dist.P2POp(dist.irecv, got, peer)])
        for r in reqs:
            r.wait()
        return bool((got == float(peer)).all())

    def exchange():
        # uneven: group rank g sends i + g + 1 rows to group rank i, each
        # row holding (sender, receiver); darray.window's collective
        k = dist.get_world_size(gx)
        g = dist.get_group_rank(gx, rank)
        send = [i + g + 1 for i in range(k)]
        recv = [g + j + 1 for j in range(k)]
        src = torch.cat([torch.tensor([[float(g), float(i)]], device=dev)
                         .expand(n, 2) for i, n in enumerate(send)])
        dst = torch.empty((sum(recv), 2), device=dev)
        dist.all_to_all_single(dst, src, output_split_sizes=recv,
                               input_split_sizes=send, group=gx)
        want = torch.cat([torch.tensor([[float(j), float(g)]]).expand(n, 2)
                          for j, n in enumerate(recv)])
        return bool(torch.equal(dst.cpu(), want))

    for name, fn in (("all_gather_into_tensor", gather),
                     ("all_reduce", reduce),
                     ("reduce_scatter_tensor", scatter),
                     ("batch_isend_irecv", p2p),
                     ("all_to_all_single", exchange)):
        _check(name, fn, out)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=None,
                   help="default: one a CUDA card")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--timeout", type=float, default=120.0)
    args = p.parse_args(argv)
    n = args.ranks or torch.cuda.device_count()
    c = 2 if n % 8 == 0 else 1
    d = math.isqrt(n // c)
    shape = (c, d, n // (c * d))
    try:
        rows = launch.launch(probe, n, shape, device=args.device,
                             backend=args.backend, timeout=args.timeout)
    except RuntimeError as exc:
        print(json.dumps({"launch": str(exc)[-2000:]}))
        return 1
    for row in rows:
        print(json.dumps(row))
    bad = [r for r in rows if any(v != "ok" for k, v in r.items()
                                  if k in ("mesh", "all_gather_into_tensor",
                                           "all_reduce",
                                           "reduce_scatter_tensor",
                                           "batch_isend_irecv",
                                           "all_to_all_single"))]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
