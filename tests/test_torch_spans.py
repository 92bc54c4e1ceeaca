"""The program's spans (`training/profiler.py::annotate`) on the CPU: the
records of root spans (nesting, one root per thread, the ring's bound, the
`profiled` flag), the profiler's ranges (none with the profiler off, one
user annotation per span under `device_trace`), the spans of a `Trainer`
step and of a two-stage sweep, and the benchmark's readers of them on tiny
copies of its cells."""

import threading

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from mvp_pytorch_tpu_torch.training import profiler
from mvp_pytorch_tpu_torch.training.optim import make_optimizer
from mvp_pytorch_tpu_torch.training.profiler import annotate, records
from mvp_pytorch_tpu_torch.training.trainer import Trainer
from torch_flags import trace_events

TRAIN_READERS = ("host_fwd_ms.train", "host_bwd_ms.train",
                 "host_update_ms.train", "host_wait_ms.train")
READERS = {"mvptr-base.pretrain-b96": TRAIN_READERS,
           "oscar-base.pretrain-b96": TRAIN_READERS,
           "mvptr-base.score-flickr1k": ("ranks_s.score",)}
STAGES = ("encode_text", "encode_image", "coarse", "rerank", "ranks")


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch single-threaded in this process: a thread per core in each of
    the suite's workers oversubscribes the host and slows the tiny cells'
    steps many times; and no intra-op thread pool is left behind for a later
    test in the same worker that forks."""
    torch.set_num_threads(1)


def test_nested_spans_add_to_their_root():
    with annotate("spans.root"):
        with annotate("spans.a"):
            with annotate("spans.b"):
                pass
            with annotate("spans.b"):
                pass
        with annotate("spans.a"):
            pass
    rec = records("spans.root")[-1]
    assert rec.name == "spans.root" and not rec.profiled
    assert sorted(rec.spans) == ["spans.a", "spans.b"]
    assert [rec.spans["spans.a"][0], rec.spans["spans.b"][0]] == [2, 2]
    # a span's time holds its children's: the root's its own and theirs
    assert rec.ns >= rec.spans["spans.a"][1] >= rec.spans["spans.b"][1] > 0
    assert not records("spans.a") and not records("spans.b")


def test_each_thread_has_its_own_root():
    seen = []

    def other():
        with annotate("spans.thread_root"):
            with annotate("spans.thread_child"):
                seen.append(threading.get_ident())

    with annotate("spans.main_root"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen
    main = records("spans.main_root")[-1]
    assert main.spans == {}
    assert set(records("spans.thread_root")[-1].spans) == {
        "spans.thread_child"}


def test_the_ring_keeps_the_last_roots():
    for i in range(profiler.RING + 5):
        with annotate("spans.ring"):
            with annotate(f"spans.ring_{i}"):
                pass
    kept = records("spans.ring")
    assert len(kept) == profiler.RING
    assert list(kept[0].spans) == ["spans.ring_5"]
    assert list(kept[-1].spans) == [f"spans.ring_{profiler.RING + 4}"]


def test_profiled_marks_roots_the_profiler_saw():
    from torch.profiler import ProfilerActivity, profile
    with annotate("spans.unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("spans.profiled"):
            pass
    # a root open when the profiler starts is profiled by a span inside
    with annotate("spans.open_at_start"):
        with profile(activities=[ProfilerActivity.CPU]):
            with annotate("spans.inner"):
                pass
    assert not records("spans.unprofiled")[-1].profiled
    assert records("spans.profiled")[-1].profiled
    assert records("spans.open_at_start")[-1].profiled


@pytest.fixture
def ranges(monkeypatch):
    """Counts of the profiler ranges the spans open: user annotations
    (`record_function`) and host-only ranges (`_RecordFunctionFast`)."""
    counts = {"user": 0, "host": 0}
    user, host = (torch.profiler.record_function,
                  torch._C._profiler._RecordFunctionFast)

    def counted(kind, make):
        def opened(name, *args):
            counts[kind] += 1
            return make(name, *args)
        return opened
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted("user", user))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counted("host", host))
    return counts


def _three_spans():
    with annotate("spans.r"):
        with annotate("spans.x"):
            with annotate("spans.y"):
                torch.ones(4).sum()


def test_no_range_with_the_profiler_off(ranges):
    _three_spans()
    assert ranges == {"user": 0, "host": 0}


def test_a_host_range_under_another_profiler(ranges):
    """Under a profiler the program did not start, each span is one host
    range on the profile's host thread, and no user annotation (which the
    profiler would mirror on the device's timeline)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _three_spans()
    assert ranges == {"user": 0, "host": 3}
    ev = [e for e in prof.events() if e.name.startswith("spans.")]
    assert sorted(e.name for e in ev) == ["spans.r", "spans.x", "spans.y"]
    assert not any(e.is_user_annotation for e in ev)


def test_each_span_is_one_user_annotation_in_a_device_trace(ranges,
                                                            tmp_path):
    prof = str(tmp_path / "prof")
    with profiler.device_trace(prof):
        _three_spans()
    assert ranges == {"user": 3, "host": 0}
    ev = [e for e in trace_events(prof)
          if e.get("name", "").startswith("spans.")]
    assert sorted((e["name"], e["cat"]) for e in ev) == [
        ("spans.r", "user_annotation"), ("spans.x", "user_annotation"),
        ("spans.y", "user_annotation")]
    assert records("spans.r")[-1].profiled


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 3)

    @property
    def device(self):
        return self.lin.weight.device


def _loss(model, batch, generator):
    out = model.lin(batch["x"])
    return (out ** 2).mean(), {"out_mean": out.mean()}


def test_a_trainer_step_records_its_phases():
    torch.manual_seed(0)
    model = _Linear()
    trainer = Trainer(model, _loss, make_optimizer(model, 0.1,
                                                   schedule="constant"),
                      grad_accum=2)
    batch = {"x": torch.randn(4, 4)}
    for _ in range(2):      # the first step also probes the memory
        out = trainer.step(batch)
        rec = records("train_step")[-1]
        assert {k: n for k, (n, _) in rec.spans.items()} == {
            "trainer.prologue": 1, "trainer.forward": 2,
            "trainer.backward": 2, "trainer.update": 1,
            "trainer.readback": 1}
        assert rec.ns >= sum(ns for _, ns in rec.spans.values())
        assert not rec.profiled
    assert set(out) == {"out_mean", "loss", "grad_norm"}


def _cell(name):
    """A tiny copy of a benchmark cell driven through its window and a
    traced window, and what its readers read."""
    c = tiny.cell(name)
    drv = c.driver.Driver(c, 2 ** 31 + 901, "cpu")
    drv.setup()
    e2e, window = drv.window(0.3)
    summary = drv.traced()
    return c, drv, harness.Readings(c, e2e, window, summary, drv.extra)


@pytest.fixture(scope="module")
def cells():
    return {name: _cell(name) for name in tiny.CELLS}


def test_a_sweep_records_its_stages(cells):
    _, drv, r = cells["mvptr-base.score-flickr1k"]
    assert all(set(res["seconds"]) == set(STAGES) for _, res in drv.sweeps)
    kept = records("two_stage_scoring")
    assert len(kept) >= r.window["units"] + 2      # warm-up, window, traced
    for rec in kept[-r.window["units"] - 1:]:
        assert {k: n for k, (n, _) in rec.spans.items()} == {
            f"retrieval.{s}": 1 for s in STAGES}
    assert kept[-1].profiled and not kept[-2].profiled


@pytest.mark.parametrize("name,metric", [
    (n, m) for n, ms in READERS.items() for m in ms])
def test_readers_read_the_window(cells, name, metric):
    c, _, r = cells[name]
    assert metric in {m["name"] for m in c.per_layer}
    got = harness.read_per_layer(c, r)
    v = got[metric]["value"]
    assert isinstance(v, float) and 0 < v < float("inf")
    assert got[metric]["unit"] == ("s" if name.endswith("flickr1k")
                                   else "ms")


@pytest.mark.parametrize("name,metric", [
    (n, m) for n, ms in READERS.items() for m in ms])
def test_readers_read_nothing_without_records(cells, monkeypatch, name,
                                              metric):
    c, _, r = cells[name]
    monkeypatch.setattr(profiler, "_ring", type(profiler._ring)())
    assert metric not in harness.read_per_layer(c, r)
