"""The program's spans and counters handed to per-layer readers
(``Run.spans``, ``Run.setup_spans``, ``Run.counters``) on the CPU at a
tiny size: the window's alone, read outside it, only in traced runs,
and the program's tracer put back however the run ends."""
import json
import sys
import types
from types import SimpleNamespace

import pytest
import torch

from tiny import make_root, run_tiny
from portbench import harness, load_module

PROBE = '''
COUNTERS = ("portbench_probe:COUNTS", "portbench_probe:N",
            "portbench_probe:T", "portbench_probe:MISSING",
            "no_such_module_anywhere:X")


def read(run):
    import portbench_probe
    portbench_probe.SEEN.append(run)
    return 1.0
'''


@pytest.fixture
def probed(tmp_path, monkeypatch):
    """A checkout whose tiny-d-alt cell reads a test reader, ``probe``,
    declaring counters of a module that counts the engine's submits."""
    from repro_torch.serving.engine import LMServingEngine
    root = make_root(tmp_path)
    (root / "portbench" / "metrics" / "probe.py").write_text(PROBE)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "probe", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "test", "moves": "rows_per_s",
        "workloads": ["tiny-d-alt"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mod = types.ModuleType("portbench_probe")
    mod.COUNTS, mod.N, mod.T, mod.SEEN = {"submits": 0}, 0.0, \
        torch.tensor(0.0), []
    monkeypatch.setitem(sys.modules, "portbench_probe", mod)
    submit = LMServingEngine.submit

    def counted(self, *a, **k):
        mod.COUNTS["submits"] += 1
        mod.N += 2.0
        mod.T += 3.0
        return submit(self, *a, **k)
    monkeypatch.setattr(LMServingEngine, "submit", counted)
    return root, mod


def test_readers_get_the_windows_spans_and_counters(probed):
    root, mod = probed
    r = run_tiny(root, "tiny-d-alt", trace=True, seconds=0.5)
    run, = mod.SEEN
    n = len(run.queries)
    warm = mod.COUNTS["submits"] - n
    assert n > 0 and warm == 2                 # one warm-up query a variant
    assert r["metrics"]["probe"]["value"] == 1.0
    # warm-up queries are set-up's, the window's queries the window's
    assert run.spans["lm_submit"][0] == run.spans["lm_batch"][0] == n
    assert run.setup_spans["lm_submit"][0] == warm
    assert run.spans["lm_submit"][1] > 0
    assert "get_pages" in run.setup_spans and "get_pages" not in run.spans
    # counters: differenced over the window; names that do not resolve
    # give nothing
    probe = {k: v for k, v in run.counters.items()
             if k.startswith("portbench_probe")}
    assert probe == {"portbench_probe:COUNTS": {"submits": float(n)},
                     "portbench_probe:N": 2.0 * n,
                     "portbench_probe:T": 3.0 * n}
    # the program's launch counts, for the split's reader (no launches
    # on the CPU)
    assert run.counters["repro_torch.kernels.ops:LAUNCHES"][
        "split_bf16x3"] == 0.0
    # the span readers read them
    for name in ("engine_host_ms", "switch_access_ms", "switch_assemble_ms",
                 "switch_rebuild_ms", "setup_fault_s", "setup_sqlite_s"):
        assert r["metrics"][name]["value"] > 0, name


def test_an_untraced_run_installs_no_tracer(probed):
    from repro_torch.obs import NULL_TRACER, get_tracer
    from repro_torch.serving.engine import LMServingEngine
    root, mod = probed
    seen, submit = [], LMServingEngine.submit

    def spy(self, *a, **k):
        seen.append(get_tracer())
        return submit(self, *a, **k)
    LMServingEngine.submit = spy
    try:
        r = run_tiny(root, "tiny-d-alt", seconds=0.3)
    finally:
        LMServingEngine.submit = submit
    assert r["correct"] and seen and all(t is NULL_TRACER for t in seen)
    assert mod.SEEN == []                       # an end-to-end run
    assert get_tracer() is NULL_TRACER


def test_the_tracer_is_put_back_when_the_run_raises(tiny_root,
                                                    monkeypatch):
    from repro_torch.obs import get_tracer, set_tracer
    from repro_torch.obs.wall import WallTracer
    mine, inside = WallTracer(), []

    def broken(*a, **k):
        inside.append(get_tracer())
        raise RuntimeError("the window broke")
    monkeypatch.setattr(harness, "window", broken)
    prev = set_tracer(mine)
    try:
        with pytest.raises(RuntimeError, match="the window broke"):
            run_tiny(tiny_root, "tiny-d", trace=True)
        assert get_tracer() is mine
    finally:
        set_tracer(prev)
    assert type(inside[0]) is WallTracer and inside[0] is not mine


def fake_run(spans=None, setup_spans=None, counters=None, queries=4):
    return SimpleNamespace(spans=spans or {}, setup_spans=setup_spans or {},
                           counters=counters or {},
                           queries=[object()] * queries)


READS = [
    ("engine_host_ms", fake_run(spans={
        "lm_submit": (4, 0.010), "lm_batch": (4, 1.030),
        "lm_load": (4, 0.400), "lm_compute": (4, 0.600)}), 10.0),
    ("switch_access_ms", fake_run(spans={"switch_access": (2, 0.25)}),
     125.0),
    ("switch_assemble_ms", fake_run(spans={"switch_assemble": (2, 0.04)}),
     20.0),
    ("switch_rebuild_ms", fake_run(spans={"switch_rebuild": (2, 0.005)}),
     2.5),
    ("setup_fault_s", fake_run(setup_spans={"load_group": (2, 50.0),
                                            "page_load": (3, 1.5)}), 51.5),
    ("setup_sqlite_s", fake_run(setup_spans={"get_pages": (2, 40.0)}),
     40.0),
    ("split_bf16x3_launches", fake_run(counters={
        "repro_torch.kernels.ops:LAUNCHES": {"split_bf16x3": 24.0,
                                             "flash_attention": 24.0}}),
     6.0),
]


@pytest.mark.parametrize("name,run,want", READS, ids=[r[0] for r in READS])
def test_each_reader_reads_its_spans_or_counter(name, run, want):
    from tiny import ROOT
    reader = load_module(ROOT / "portbench", "metrics", name)
    assert reader.read(run) == pytest.approx(want)
    # with nothing to read it reads nothing
    assert reader.read(fake_run()) is None


@pytest.mark.parametrize("value,want", [
    ({"a": 1, "b": 2.5}, {"a": 1.0, "b": 2.5}), (3, 3.0),
    (torch.tensor(4.0), 4.0), ("text", None), ({"a": "x"}, None),
    (torch.ones(2), None), (True, None)])
def test_a_counter_is_numbers(monkeypatch, value, want):
    mod = types.ModuleType("portbench_counter_probe")
    mod.X = value
    monkeypatch.setitem(sys.modules, "portbench_counter_probe", mod)
    assert harness.read_counter("portbench_counter_probe:X") == want


def test_counter_and_span_differences():
    assert harness.counter_delta({"a": 1.0}, {"a": 4.0, "b": 2.0}) == \
        {"a": 3.0, "b": 2.0}
    assert harness.counter_delta(1.0, 3.5) == 2.5
    assert harness.counter_delta(None, 3.5) is None
    assert harness.span_delta({"x": (1, 0.5), "y": (2, 1.0)},
                              {"x": (3, 2.0), "y": (2, 1.0), "z": (1, 0.1)}) \
        == {"x": (2, 1.5), "z": (1, 0.1)}
