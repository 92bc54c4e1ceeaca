"""The benchmark's machinery: finding a cell's pieces by name, the run's
environment, the comparison that decides `correct`, and the result line.

A cell (`BENCHMARK.json` `workloads`) names a configuration and a traffic
mix. Its pieces are files of their own, found by name:
- `configs/<config>.json`: the model's sizes, its `family` (the reference
  module `reference/<family>.py`) and its source;
- `traffic/<traffic>.json`: the traffic parameters and the `driver`
  (`drivers/<driver>.py`) that runs them;
- `limits/<cell>.json`: the limit of each number the cell's check
  compares, with the readings it was set from;
- `flops/<config>.py`: the configuration's model FLOPs;
- `metrics/<metric>.py`: one reader per per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
BANNED = ("jax", "jaxlib", "flax", "mvp_pytorch_tpu")


def run_env() -> None:
    """Set before torch is imported: every compile cache at a fixed
    directory inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module of the benchmark by its file path (names may hold dots and
    dashes)."""
    name = "_bench_" + os.path.relpath(path, BENCH).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of `BENCHMARK.json` and its pieces."""

    def __init__(self, name: str, config: dict, traffic: dict, chips: int,
                 limits: Dict[str, dict], end_to_end: list, per_layer: list):
        self.name = name
        self.config = config
        self.traffic = traffic
        self.chips = chips
        self.limits = limits
        self.end_to_end = end_to_end
        self.per_layer = per_layer

    @property
    def driver(self):
        return load_module(os.path.join(BENCH, "drivers",
                                        self.traffic["driver"] + ".py"))

    def flops(self):
        return load_module(os.path.join(BENCH, "flops",
                                        self.config["name"] + ".py"))


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with `workloads` applies to those cells; a per-layer one
    without applies wherever the metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[name]
    config = load_json(os.path.join(BENCH, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(BENCH, "traffic",
                                     w["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, config, traffic, w["chips"], limits, e2e, per_layer)


def banned_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def compare(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, checks): each number beside its limit; a missing or
    non-finite number fails."""
    checks, ok = {}, True
    for key, lim in limits.items():
        if key.startswith("_"):
            continue
        v = numbers.get(key)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok &= good
        checks[key] = {"value": v if v is None or math.isfinite(v)
                       else str(v), "limit": lim["limit"]}
    return ok, checks


class Readings:
    """What a per-layer reader reads: the cell, the run's end-to-end values,
    its window (seconds and units of work, host clock), the traced window's
    `trace.Summary`, and anything the driver adds under `extra`."""

    def __init__(self, cell: Cell, e2e: dict, window: dict, summary,
                 extra: dict):
        self.cell, self.e2e, self.window = cell, e2e, window
        self.summary, self.extra = summary, extra

    def peak_flops(self) -> float:
        peaks = load_json(os.path.join(BENCH, "flops", "peaks.json"))
        return peaks["flops_per_s"][self.cell.config["dtype"]]


def read_per_layer(cell: Cell, readings: Readings) -> dict:
    out = {}
    for m in cell.per_layer:
        mod = load_module(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        v = mod.read(readings)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """Run one cell once; -> the result object (not yet printed)."""
    import time

    import torch
    drv = cell.driver.Driver(cell, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    e2e, window = drv.window(seconds)
    summary = drv.traced() if trace else None
    memory_peak = drv.memory_peak()
    drv.free()
    numbers = drv.check()
    correct, checks = compare(numbers, cell.limits)
    if trace:
        metrics = read_per_layer(cell, Readings(cell, e2e, window, summary,
                                                drv.extra))
    else:
        e2e["setup_s"] = setup_s
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = torch.device(device)
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": memory_peak}}
    if trace:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    for line in drv.notes + (summary.notes if trace else []):
        log(line, file=sys.stderr)
    for key, c in checks.items():
        log(f"check {key} {c['value']} limit {c['limit']}", file=sys.stderr)
    result["checks"] = checks
    leaked = banned_modules()
    if leaked:
        raise SystemExit(f"modules that the run may not load: {leaked}")
    return result
