"""A configuration is added by files alone. In a copy of BENCHMARK.json and
benchmark/, a fourth configuration comes with a new entry, flop formula,
operand class and per-layer metric, a `reduced` that is not empty, a
traffic mix and a cell: new files and new entries of BENCHMARK.json,
with a stub adapter and reference in plain torch. The copy's own file
tests pass and take the new cell, no file that was there changes, and a
run of the new cell on the CPU through the harness is correct."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from benchmark import spec

CELL = "stub.n96"
FILES = {
    "configs/stub_lu_f32.json": {
        "name": "stub_lu_f32",
        "source": "https://www.netlib.org/benchmark/hpl/",
        "entry": "stub_lu", "calls": "torch.linalg.lu_factor",
        "operand": "stub_uniform", "dtype": "float32",
        "precision": "highest", "lower_precision": "high",
        "settings": {}, "shape": {}, "flops": "stub_lu",
        "reduced": ["n"],
        "assumed": {"n": {
            "published": "HPL's rule: about 80 % of the memory",
            "why": "a test's size, cut so that a call takes a millisecond"}}},
    "traffic/n96.json": {"loop": "closed", "callers": 1, "pool": 2,
                         "shape": {"n": 96}, "sample": {"among": [1, 3]}},
    f"workloads/{CELL}.json": {"config": "stub_lu_f32", "traffic": "n96",
                               "chips": 1, "limits": {"residual": 1e-5}},
    "entries/stub_lu.py": '''
        """A stub adapter: torch.linalg.lu_factor on one device."""

        import torch


        class Entry:
            def __init__(self, config, dims, device, world):
                if world:
                    raise ValueError("stub_lu runs on one device")

            def operand(self, local):
                return local

            def __call__(self, a):
                return torch.linalg.lu_factor(a)

            @staticmethod
            def outputs(result):
                lu, piv = result
                return {"LU": lu, "piv": piv}
        ''',
    "reference/stub_lu.py": '''
        """A stub reference: ||P L U - A|| / ||A|| in float64."""

        import torch

        from benchmark.reference import plain


        def check(a, outputs, config, comm=plain.OneDevice()):
            p, lo, up = torch.lu_unpack(outputs["LU"].double(),
                                        outputs["piv"])
            return {"residual": plain.rel_fro(p @ lo @ up, a.double())}


        def control(a, config, comm=plain.OneDevice()):
            lu, piv = torch.linalg.lu_factor(plain.tf32(a))
            return {"LU": lu, "piv": piv}
        ''',
    "formulas/stub_lu.py": '''
        """stub_lu: 2 n^3 / 3."""


        def per_call(n, **_):
            return 2.0 * n**3 / 3.0
        ''',
    "operands/stub_uniform.py": '''
        """stub_uniform: n x n uniform in (-0.5, 0.5), on one device."""

        import torch


        def make(dims, seed, device, dtype, rank, ranks):
            if ranks != 1:
                raise ValueError("made on one device")
            g = torch.Generator(device=device).manual_seed(seed)
            n = dims["n"]
            return torch.rand((n, n), generator=g, device=device,
                              dtype=dtype).sub_(0.5)
        ''',
    "metrics/stub_calls.py": '''
        """Calls in the window, rank 0."""


        def read(r):
            return float(len(r.calls))
        ''',
}
ENTRIES = {
    "configs": {"name": "stub_lu_f32",
                "source": "https://www.netlib.org/benchmark/hpl/",
                "file": "benchmark/configs/stub_lu_f32.json",
                "reduced": ["n"], "why": "a stub: LU of a uniform matrix"},
    "workloads": {"name": CELL, "config": "stub_lu_f32", "traffic": "n96",
                  "chips": 1, "why": "n = 96, pool 2, one caller"},
    "per_layer": {"name": "stub_calls", "unit": "calls", "better": "higher",
                  "source": "host_clock", "layer": "algorithm",
                  "moves": "gflops", "workloads": [CELL]},
}
RUN = """
import json, sys, torch
sys.path.insert(0, ".")
from benchmark import harness, run, spec
assert str(spec.HERE) == {here!r}, spec.HERE
cell = spec.cell({cell!r})
r = harness.run(cell, 2**31 + 5, 0.5, False, torch.device("cpu"))
readings = harness.Readings(cell, 1.0, [r])
print(json.dumps([run.result(readings, t)[0] for t in (False, True)]))
"""


def _files(root) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTEST_ADDOPTS")}
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    p = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    return p.stdout


def test_a_configuration_is_added_by_files_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(tmp_path)
    for rel, body in FILES.items():
        path = tmp_path / "benchmark" / rel
        assert not path.exists(), rel
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    bench = json.loads(before["BENCHMARK.json"])
    for key, entry in ENTRIES.items():
        bench[key].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    out = _run(["-m", "pytest", "benchmark/tests/test_bench_files.py", "-v",
                "-p", "no:cacheprovider"], tmp_path)
    assert f"test_cell_files[{CELL}] PASSED" in out, out[-4000:]

    plain, traced = json.loads(_run(["-c", RUN.format(
        here=str(tmp_path / "benchmark"), cell=CELL)],
        tmp_path).strip().splitlines()[-1])
    assert plain["correct"] is True and plain["failed"] == 0
    assert plain["checked"]["residual"]["value"] < 1e-5
    assert plain["metrics"]["gflops"]["value"] > 0
    assert set(plain["metrics"]) == {"gflops", "peak_mem_gib", "setup_s"}
    assert traced["metrics"]["stub_calls"]["value"] == plain["attempted"]

    # what was there is the repo's, byte for byte; BENCHMARK.json only
    # gained entries
    after = _files(tmp_path)
    for rel, data in before.items():
        assert (spec.ROOT / rel).read_bytes() == data, rel
        if rel != "BENCHMARK.json":
            assert after[rel] == data, rel
    old, new = (json.loads(f["BENCHMARK.json"]) for f in (before, after))
    assert set(new) == set(old)
    for key in old:
        want = old[key] + [ENTRIES[key]] if key in ENTRIES else old[key]
        assert new[key] == want, key
