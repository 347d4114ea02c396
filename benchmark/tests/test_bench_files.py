"""Every file the harness finds by name parses and keeps to the shape
BENCHMARK.json and its names and units must have. Any configuration that
keeps these rules is taken: nothing here names one."""

import ast
import json
import re

import pytest

from benchmark import flops, spec, traffic

BENCH = spec.benchmark_json()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        spec.check_name(n)
    for w in BENCH["workloads"]:
        spec.check_name(w["traffic"])
        assert ONE_LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)


def test_metric_keys_and_layers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert ONE_LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def _defines(path, names) -> bool:
    """Whether the Python file at `path` defines each of `names` at its
    top level (read, not imported: an adapter imports the program)."""
    tree = ast.parse(path.read_text())
    top = {n.name for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    return set(names) <= top


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = spec.cell(name)
    assert _defines(spec.HERE / "entries" / f"{cell.entry}.py", ["Entry"])
    assert _defines(spec.HERE / "reference" / f"{cell.entry}.py",
                    ["check", "control"])
    assert _defines(spec.HERE / "formulas"
                    / f"{spec.check_name(cell.config['flops'])}.py",
                    ["per_call"])
    assert _defines(spec.HERE / "operands"
                    / f"{spec.check_name(cell.config['operand'])}.py",
                    ["make"])
    assert cell.config["precision"] in ("highest", "high", "default")
    assert cell.traffic["loop"] == "closed"
    assert cell.traffic["callers"] == 1 and cell.traffic["pool"] >= 1
    dims = traffic.shape(cell.config, cell.traffic)
    assert flops.per_call(cell.config, dims) > 0
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_configs_state_their_cut():
    # each key cut from the source is named in `reduced`, alike in
    # BENCHMARK.json and the file, and the file's `assumed` states the
    # published value and why it was cut; no width is cut
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert cfg["reduced"] == c["reduced"]
        assert len(set(c["reduced"])) == len(c["reduced"])
        for key in c["reduced"]:
            spec.check_name(key)
            assert not key.endswith(("_dim", "_rank")), key
            stated = cfg["assumed"][key]
            assert set(stated) == {"published", "why"}, (c["name"], key)
            assert ONE_LINE.match(stated["why"])
            assert ONE_LINE.match(str(stated["published"]))


def test_a_kernel_metric_names_its_cells():
    # a metric that reads kernels by name lists the cells they run in,
    # so that a cell of another configuration does not silently lack it
    for m in BENCH["per_layer"]:
        text = (spec.HERE / "metrics" / f"{m['name']}.py").read_text()
        if "ms_per_call" in text:
            assert "workloads" in m, m["name"]


def test_every_file_under_paths_is_named_from_name_characters():
    for p in spec.HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_a_cell_the_benchmark_does_not_list_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such.cell")
    with pytest.raises(ValueError):
        spec.cell("bad name")
