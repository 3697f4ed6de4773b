"""The port's tracer on the wall clock (``obs/wall.py``): ``WallTracer``
spans in seconds, per-name totals that outlive the ring, ``profile=True``
spans as ``torch.profiler`` ranges, the LM serving path's span tree, and
the CLI's direct-path trace stamped in wall seconds."""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import build_lm_store
from repro_torch.models import build
from repro_torch.obs import NULL_TRACER, get_tracer, use_tracer
from repro_torch.obs.export import load_trace
from repro_torch.obs.wall import WallClock, WallTracer
from repro_torch.serving import StorageModel, WeightServer
from repro_torch.serving.engine import LMServingEngine

torch.set_num_threads(2)


def test_wall_clock_spans_are_growing_seconds():
    tr = WallTracer()
    assert isinstance(tr.clock, WallClock)
    with tr.span("outer"):
        time.sleep(0.02)
        with tr.span("inner"):
            time.sleep(0.01)
    with tr.span("after"):
        pass
    inner, outer, after = tr.spans()
    assert (inner.name, outer.name, after.name) == ("inner", "outer", "after")
    assert 0.01 <= inner.duration < outer.duration < 5.0
    assert outer.duration >= 0.03
    assert outer.start_t < inner.start_t <= inner.end_t <= outer.end_t \
        <= after.start_t <= after.end_t
    assert tr.clock.channels == {}
    tr.assert_matches_clock()


class _Ticks:
    """A clock that advances one second a reading."""

    def __init__(self):
        self.t = 0.0
        self.channels = {}

    @property
    def now(self):
        self.t += 1.0
        return self.t


def test_totals_count_the_spans_the_ring_evicted():
    tr = WallTracer(_Ticks(), ring=2)     # each span lasts 1.0
    for _ in range(5):
        with tr.span("x"):
            pass
    with tr.span("y"):
        with tr.span("x"):
            pass
    assert len(tr.spans()) == 2 and tr.dropped == 5
    assert tr.totals["x"] == (6, 6.0)
    assert tr.totals["y"] == (1, 3.0)
    before = dict(tr.totals)
    with tr.span("x"):
        pass
    assert before["x"] == (6, 6.0) and tr.totals["x"] == (7, 7.0)


def _ranges(prof):
    return {e.name: e for e in prof.events() if e.name.startswith("span:")}


def test_profile_spans_are_profiler_ranges_around_their_work():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(64, 64)
    tr = WallTracer(profile=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer"):
            with tr.span("inner"):
                a @ a
            with pytest.raises(ZeroDivisionError):
                with tr.span("raises"):
                    1 / 0
            a + a
    got = _ranges(prof)
    assert set(got) == {"span:outer", "span:inner", "span:raises"}
    outer, inner = got["span:outer"].time_range, got["span:inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm and all(inner.start <= e.time_range.start
                      and e.time_range.end <= inner.end for e in mm)
    assert tr.spans()[1].attrs["error"] == "ZeroDivisionError"
    assert tr.totals["outer"][0] == 1

    plain = WallTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with plain.span("outer"):
            a @ a
    assert not _ranges(prof)


def _engine(arch):
    cfg = reduced(get_config(arch))
    store, names, lm = build_lm_store(cfg, 2, index_mode="torch")
    server = WeightServer(store, store.num_pages(),
                          storage=StorageModel("dram"), backend="device",
                          kernel_mode="torch")
    api = build(cfg)
    return LMServingEngine(server, {n: api for n in names},
                           {n: {"rebuild": lm.rebuild} for n in names}), \
        names


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b"])
def test_lm_engine_span_tree(arch):
    engine, names = _engine(arch)
    tr = WallTracer()
    prompts = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    with use_tracer(tr):
        for name in names + names[:1]:
            engine.submit(name, prompts, steps=2)
            engine.run()
    assert get_tracer() is NULL_TRACER
    spans = tr.spans()
    by_id = {s.sid: s for s in spans}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    def children(s):
        return [c.name for c in spans if c.parent == s.sid
                and c.kind != "policy"]

    batches = tr.find("lm_batch")
    submits = tr.find("lm_submit")
    assert len(batches) == len(submits) == 3
    assert [b.attrs["query"] for b in batches] \
        == [s.attrs["query"] for s in submits] == [0, 1, 2]
    for b, s in zip(batches, submits):
        assert parent(b) is parent(s) is None
        assert b.attrs["model"] == s.attrs["model"]
        assert b.attrs["rows"] == s.attrs["rows"] == 2
        assert children(b) == ["lm_schedule", "lm_load", "lm_compute"]
    switches = tr.find("model_switch")
    assert len(switches) == 3            # lm-v0, lm-v1, back to lm-v0
    for sw in switches:
        assert parent(sw) == "lm_load"
        assert children(sw) == ["switch_access", "switch_assemble",
                                "switch_rebuild"]
        assert sum(c.duration for c in spans if c.parent == sw.sid) \
            <= sw.duration
    access = tr.find("switch_access")
    assert access[0].attrs["misses"] == access[0].attrs["pages"] > 0
    ssd = tr.find("ssd_chunked")
    if arch == "hymba-1.5b":
        assert ssd and all(parent(s) == "lm_compute" for s in ssd)
        assert all(s.attrs["chunks"] >= 1 for s in ssd)
    else:
        assert not ssd
    assert not tr.find(kind="kernel")
    for name in ("lm_batch", "lm_submit", "model_switch"):
        count, seconds = tr.totals[name]
        assert count == 3
        assert seconds == pytest.approx(sum(s.duration
                                            for s in tr.find(name)))


@pytest.mark.parametrize("engine", ["embedding", "lm"])
def test_cli_direct_trace_is_in_wall_seconds(tmp_path, engine):
    from repro_torch.launch.serve import main as serve_main
    path = tmp_path / "t.json"
    args = ["--backend", "numpy", "--models", "3", "--vocab", "512",
            "--batches", "4", "--trace", str(path)]
    if engine == "lm":
        args += ["--engine", "lm", "--lm-steps", "2"]
    t0 = time.perf_counter()
    serve_main(args)
    wall = time.perf_counter() - t0
    doc = json.loads(path.read_text())
    assert doc["otherData"]["clock_channels"] == {}
    spans = load_trace(str(path))
    roots = [s for s in spans if s["parent"] is None]
    assert roots and all(s["end_t"] >= s["start_t"] for s in spans)
    # stamps are perf_counter seconds: the roots tile part of the run
    assert 0.0 < sum(s["end_t"] - s["start_t"] for s in roots) <= wall
    assert t0 <= min(s["start_t"] for s in spans) \
        <= max(s["end_t"] for s in spans) <= t0 + wall
    dur = sum(e["dur"] for e in doc["traceEvents"] if e["ph"] == "X"
              and "parent" not in e["args"])
    assert dur == pytest.approx(
        sum(s["end_t"] - s["start_t"] for s in roots) * 1e6)
