"""The benchmark finds every piece of a cell by name, and a new cell is a
new entry and new files, with no existing file edited."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert os.path.exists(os.path.join(harness.BENCH, "reference",
                                       data["family"] + ".py"))
    assert os.path.exists(os.path.join(harness.BENCH, "flops",
                                       cfg["name"] + ".py"))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(w):
    c = harness.find_cell(w["name"])
    assert c.config["name"] == w["config"]
    assert c.driver.Driver is not None
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(k for k in c.limits if not k.startswith("_"))
    for m in c.per_layer:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_is_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell (another batch size of the
    training mix) by one BENCHMARK.json entry, a traffic file and a limits
    file; the harness finds and runs it, and no file it had changed."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digest(root / "benchmark")
    bench = copy.deepcopy(BENCH)
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "mvptr-base.pretrain-b48", "config": "mvptr-base",
        "traffic": "pretrain-b48", "chips": 1, "why": "half the batch"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "mvptr-base.pretrain-b96" in m["workloads"]:
            m["workloads"] = m["workloads"] + ["mvptr-base.pretrain-b48"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = harness.load_json(os.path.join(harness.BENCH, "traffic",
                                        "pretrain-b96.json"))
    (root / "benchmark/traffic/pretrain-b48.json").write_text(
        json.dumps({**tr, "batch": 48}))
    shutil.copy(os.path.join(harness.BENCH, "limits",
                             "mvptr-base.pretrain-b96.json"),
                root / "benchmark/limits/mvptr-base.pretrain-b48.json")
    code = (
        "import sys, json; sys.path.insert(0, '.');"
        f"sys.path.append({harness.ROOT!r});"
        "from benchmark import harness;"
        "from benchmark.tests import tiny;"
        "c = tiny.cell('mvptr-base.pretrain-b48');"
        "r = tiny.run(c);"
        "b = harness.find_cell('mvptr-base.pretrain-b48').traffic['batch'];"
        "print(json.dumps([harness.BENCH, b, r['correct'],"
        " sorted(r['metrics'])]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    bench_dir, batch, correct, metrics = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert bench_dir == str(root / "benchmark")
    assert batch == 48
    assert correct is True
    assert metrics == ["setup_s", "train_samples_per_s"]
    after = _digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
