"""The port stands alone: capital_tpu_torch imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU unasked, and
chip_smoke.py fails without a GPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import capital_tpu_torch
from capital_tpu_torch import Grid, interop
from capital_tpu_torch.algs import cholinv
from capital_tpu_torch.bench.common import device_of

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "capital_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "capital_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        capital_tpu_torch.__path__, "capital_tpu_torch."))


def _cpu_only_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_cpu_only_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_walk_covers_the_solver_modules():
    """The import check above walks these, the modules of the solver
    slice among them."""
    assert {"capital_tpu_torch.linalg", "capital_tpu_torch.algs.polar",
            "capital_tpu_torch.algs.newton", "capital_tpu_torch.algs.tsqr",
            "capital_tpu_torch.bench.solve",
            "capital_tpu_torch.bench.inverse"} <= set(_modules())


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    # exact names: capital_tpu_torch starts with capital_tpu
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots


def test_grid_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Grid.square()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_of(type("Args", (), {"device": "cuda"})())
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.dist_matrix_from_numpy(np.eye(4, dtype=np.float32), (4, 4))
    grid = Grid.square(device="cpu")
    assert (grid.platform, grid.shape, grid.num_devices) == ("cpu",
                                                              (1, 1, 1), 1)
    assert (grid.c, grid.d, grid.d1, grid.d2, grid.is_square) == (
        1, 1, 1, 1, True)
    x = torch.ones(2)
    assert grid.constrain(x) is x


def test_factor_refuses_an_operand_off_the_grid_device():
    """A CPU operand on a CUDA grid would quietly run the plain versions
    on the CPU; factor refuses it before any work."""
    grid = Grid(device=torch.device("cuda", 0))
    a = interop.dist_matrix_from_numpy(4 * np.eye(256, dtype=np.float32),
                                       (256, 256), device="cpu")
    with pytest.raises(ValueError, match="grid on cuda:0"):
        cholinv.factor(grid, a, cholinv.Config(min_bc=128))


@pytest.mark.parametrize("c,d", [(2, 1), (1, 2), (2, 2)])
def test_multi_device_grid_is_not_ported_yet(c, d):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Grid.square(c=c, d=d, device="cpu")


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without a card it exits non-zero and prints no result; alone in a
    directory (no package beside it) it does the same."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=_cpu_only_env(), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
