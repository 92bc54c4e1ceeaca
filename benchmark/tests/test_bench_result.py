"""The result line's keys, the refusal to run without the card or without
the program, and the modules a run may not load."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_result_keys(name, trace):
    c = tiny.cell(name)
    r = tiny.run(c, trace=trace)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    for k, v in r["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    assert set(r["checks"]) == {k for k in c.limits if not k.startswith("_")}
    json.dumps(r)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", tiny.CELLS[0],
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the program is missing: the run raises before any result."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.tests import tiny;"
            "print(tiny.run(tiny.cell(tiny.CELLS[0])))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "mvp_pytorch_tpu_torch" in out.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def _sources(sub=""):
    root = os.path.join(harness.BENCH, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_imports():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in harness.BANNED, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "numpy", "math",
                                          "typing", "importlib",
                                          "__future__"), (path, name)


def test_run_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from benchmark import harness; from benchmark.tests import tiny;"
            "[tiny.run(tiny.cell(n)) for n in tiny.CELLS];"
            "print(json.dumps(harness.banned_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
