"""Checkpoint and interchange IO for factors (counterpart of
capital_tpu/io.py).

  * save_factor / load_factor: a triangular factor in PACKED form,
    n(n+1)/2 floats in an .npz with `packed`, `n`, `upper` and the
    caller's metadata, through the host layout engine (native.py). The
    file is the JAX package's: one written by either package loads in the
    other.
  * export_block_cyclic / import_block_cyclic: ScaLAPACK-style
    block-cyclic panels.
  * save_sharded / load_sharded: a tree of tensors (nested dicts, lists
    and tuples; DistMatrix leaves as their `.data`) through
    torch.distributed.checkpoint, the counterpart of the JAX package's
    orbax checkpoints of any pytree. A dict is stored as it is; a list or
    tuple tree is stored as nested dicts keyed by position ('0', '1',
    ...), and load_sharded rebuilds its containers from the template.
    Without a process group it runs in this process alone.

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


def _as_dicts(tree):
    """The tree with every list and tuple turned into a dict keyed by
    position ('0', '1', ...): the form the checkpoint stores."""
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_dicts(v) for i, v in enumerate(tree)}
    return tree


def _like(template, tree):
    """Undo _as_dicts: `tree` rebuilt with the containers of `template`."""
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, tree[str(i)])
                              for i, v in enumerate(template))
    return tree


def _checkpoint_tree(tree):
    """The tree as the checkpoint stores it: a dict as it is, a list or
    tuple through _as_dicts; a bare leaf is refused (as orbax does)."""
    tree = tree_map_distmatrix(tree)
    if isinstance(tree, dict):
        return tree
    if isinstance(tree, (list, tuple)):
        return _as_dicts(tree)
    raise ValueError("save_sharded/load_sharded take a dict, list or tuple "
                     f"of tensors, not a bare {type(tree).__name__}")


def save_sharded(path: str, tree):
    """Checkpoint a tree of tensors (nested dicts, lists and tuples;
    DistMatrix leaves included) with torch.distributed.checkpoint into
    directory `path`."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_checkpoint_tree(tree), checkpoint_id=_abspath(path),
             no_dist=_single_process())


def load_sharded(path: str, template):
    """Restore a save_sharded checkpoint into tensors shaped like
    `template`'s (the saved tree's structure, with tensors or DistMatrix
    leaves; each restored tensor lies on its template's device). Returns
    the restored tree, with the template's containers; the template is
    not written."""
    import torch.distributed.checkpoint as dcp

    template = tree_map_distmatrix(template)
    out = _checkpoint_tree(_tree_map(
        lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor) else x,
        template))
    dcp.load(out, checkpoint_id=_abspath(path), no_dist=_single_process())
    return out if isinstance(template, dict) else _like(template, out)


def export_block_cyclic(a, pr: int, pc: int, bb: int = 32) -> np.ndarray:
    """(m, n) -> (pr*pc, lm, ln) block-cyclic panels (ScaLAPACK layout)."""
    return native.block_to_cyclic(native._f32c(a), pr, pc, bb)


def import_block_cyclic(panels, m: int, n: int, pr: int, pc: int,
                        bb: int = 32) -> np.ndarray:
    return native.cyclic_to_block(panels, m, n, pr, pc, bb)
