"""Checkpoint and interchange IO for factors (counterpart of
capital_tpu/io.py).

  * save_factor / load_factor: a triangular factor in PACKED form,
    n(n+1)/2 floats in an .npz with `packed`, `n`, `upper` and the
    caller's metadata, through the host layout engine (native.py). The
    file is the JAX package's: one written by either package loads in the
    other.
  * export_block_cyclic / import_block_cyclic: ScaLAPACK-style
    block-cyclic panels.
  * save_sharded / load_sharded: a nested dict of tensors (DistMatrix
    leaves as their `.data`) through torch.distributed.checkpoint, the
    counterpart of the JAX package's orbax checkpoints. Without a process
    group it runs in this process alone.

Arrays come back as numpy f32, as the JAX package returns them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from capital_tpu_torch import native
from capital_tpu_torch.matrix import DistMatrix


def save_factor(path: str, r, *, upper: bool = True, meta: dict | None = None):
    """Save a triangular factor (tensor or array) packed: half the dense
    bytes."""
    arr = native._f32c(r)
    n = arr.shape[0]
    packed = native.pack_triangle(arr, upper=upper)
    np.savez_compressed(path, packed=packed, n=n, upper=upper,
                        **(meta or {}))


def load_factor(path: str) -> tuple[np.ndarray, dict]:
    """Load a packed factor back to dense; returns (array, metadata)."""
    with np.load(path) as z:
        n = int(z["n"])
        upper = bool(z["upper"])
        dense = native.unpack_triangle(z["packed"], n, upper=upper)
        meta = {k: z[k] for k in z.files if k not in ("packed", "n", "upper")}
    return dense, meta


def _tree_map(fn, tree):
    """fn over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map_distmatrix(tree):
    """DistMatrix leaves -> their .data tensors (the checkpoint holds the
    payload; shape and structure are config the caller regenerates). The
    counterpart of the JAX package's jax_tree_map_distmatrix."""
    return _tree_map(
        lambda x: x.data if isinstance(x, DistMatrix) else x, tree)


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _single_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized())


def save_sharded(path: str, tree: dict):
    """Checkpoint a nested dict of tensors (DistMatrix leaves included)
    with torch.distributed.checkpoint into directory `path`."""
    import torch.distributed.checkpoint as dcp

    dcp.save(tree_map_distmatrix(tree), checkpoint_id=_abspath(path),
             no_dist=_single_process())


def load_sharded(path: str, template: dict) -> dict:
    """Restore a save_sharded checkpoint into tensors shaped like
    `template`'s (a nested dict of tensors or DistMatrix; each restored
    tensor lies on its template's device). Returns the restored tree; the
    template is not written."""
    import torch.distributed.checkpoint as dcp

    out = _tree_map(
        lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor) else x,
        tree_map_distmatrix(template))
    dcp.load(out, checkpoint_id=_abspath(path), no_dist=_single_process())
    return out


def export_block_cyclic(a, pr: int, pc: int, bb: int = 32) -> np.ndarray:
    """(m, n) -> (pr*pc, lm, ln) block-cyclic panels (ScaLAPACK layout)."""
    return native.block_to_cyclic(native._f32c(a), pr, pc, bb)


def import_block_cyclic(panels, m: int, n: int, pr: int, pc: int,
                        bb: int = 32) -> np.ndarray:
    return native.cyclic_to_block(panels, m, n, pr, pc, bb)
