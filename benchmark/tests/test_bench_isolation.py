"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's),
and the yardstick (the plain references, the flop formulas, the operand
classes) loads nothing of the program."""

import ast
import json
import subprocess
import sys

from benchmark import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "capital_tpu"}

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    p = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(spec.ROOT),
                                             body=body)],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_readers_references_and_entries_load_no_jax():
    body = """
import runpy
from benchmark import calibrate, devtrace, flops, harness, spec, traffic
runpy.run_path(str(spec.HERE / "run.py"), run_name="not_main")
bench = spec.benchmark_json()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
for c in bench["configs"]:
    cfg = spec.load_json(spec.ROOT / c["file"])
    spec.entry_module(cfg["entry"])
    spec.reference_module(cfg["entry"])
    spec.load("formulas", cfg["flops"])
    spec.load("operands", cfg["operand"])
"""
    top = _loaded(body)
    assert "capital_tpu_torch" in top and "benchmark" in top
    assert not top & FORBIDDEN


def test_references_load_nothing_of_the_program():
    # the yardstick: plain references, flop formulas, operand classes
    top = _loaded("""
import importlib
from benchmark import spec
for p in sorted((spec.HERE / "reference").glob("*.py")):
    importlib.import_module("benchmark.reference." + p.stem)
for folder in ("formulas", "operands"):
    for p in sorted((spec.HERE / folder).glob("*.py")):
        if p.stem != "__init__":
            spec.load(folder, p.stem)
""")
    assert "torch" in top
    assert not top & (FORBIDDEN | {"capital_tpu_torch"})
    for folder in ("reference", "formulas", "operands"):
        for p in (spec.HERE / folder).glob("*.py"):
            for node in ast.walk(ast.parse(p.read_text())):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN | {
                        "capital_tpu_torch"}, (p.name, n)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "capital_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "capital_tpu.ops", sys)
    assert set(harness.forbidden_modules()) == before | {"capital_tpu"}
