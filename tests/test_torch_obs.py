"""The request path's observability in the port: the frontend tests of
``tests/test_obs.py`` run through the port's frontend and engines.

Per-channel span time equals the virtual clock's ledger exactly (1
shard, on the port's host simulator and on its device path in the
``torch`` kernel mode; 2 shards in the ``torch`` kernel mode); every
served request's span carries exact stage identities; tracing on and off
give bit-identical results; a port run's Chrome trace validates,
round-trips and passes ``scripts/trace_report.py``; and the
``REPORT_FIELDS`` audit holds against the port's ``ServeStats`` and
``launch/serve.py``, the ``[shards]`` line's six fields checked against
a 2-shard CLI run.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.launch.serve import REPORT_FIELDS, build_store
from repro_torch.obs import (NULL_TRACER, Tracer, to_chrome_trace,
                             use_tracer, validate_chrome_trace, write_trace)
from repro_torch.obs.export import load_trace
from repro_torch.serving import (BatchComputeModel, EmbeddingServingEngine,
                                 OpenLoopTraffic, ServeStats, ServingFrontend,
                                 ShardedWeightServer, StorageModel,
                                 WeightServer)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BACKENDS = [("numpy", "auto"), ("device", "torch")]


def _scenario(vocab=512, d=32, num_models=3, block=(32, 32), l=4, seed=0):
    task = SyntheticTextTask(vocab=vocab, d=d, seed=seed)
    store, heads = build_store(task, num_models=num_models,
                               block_shape=block, blocks_per_page=l,
                               index_mode="host")
    return task, store, heads


def _doc_payload(task, docs_per_req=3, seed_base=700):
    def payload(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(docs_per_req, variant=v,
                              seed=seed_base + rid)
        return docs
    return payload


def _traced_run(backend=BACKENDS[0], n=40, rate=400.0, tracer=None,
                shards=1):
    task, store, heads = _scenario(num_models=3)
    if shards == 1:
        server = WeightServer(store, max(2, store.num_pages() // 2),
                              storage=StorageModel("dram"),
                              backend=backend[0], kernel_mode=backend[1])
    else:
        server = ShardedWeightServer(store, max(4, store.num_pages() - 2),
                                     storage=StorageModel("dram"),
                                     shards=shards, placement="sharers",
                                     kernel_mode=backend[1])
    engine = EmbeddingServingEngine(server, heads, scheduler="fifo")
    fe = ServingFrontend(engine, max_batch=4,
                         compute_model=BatchComputeModel())
    gen = OpenLoopTraffic([f"word2vec-v{v}" for v in range(3)],
                          rate=rate, zipf_alpha=1.1, slo_s=0.5, seed=5,
                          payload_fn=_doc_payload(task))
    if tracer is None:
        tracer = Tracer(clock=fe.clock)
    with use_tracer(tracer):
        st = fe.run(gen.generate(n))
    return fe, st, tracer


@pytest.mark.parametrize("backend,shards", [
    pytest.param(BACKENDS[0], 1, id="backend0"),
    pytest.param(BACKENDS[1], 1, id="backend1"),
    pytest.param(BACKENDS[1], 2, id="shards2-torch")])
def test_frontend_run_span_channels_equal_clock_exactly(backend, shards):
    fe, st, tracer = _traced_run(backend, shards=shards)
    assert len(st.request_latencies) > 0
    assert tracer.dropped == 0
    assert set(fe.clock.channels) == set(tracer.channel_seconds)
    for ch in fe.clock.channels:
        assert tracer.channel_seconds[ch] == fe.clock.spent(ch)
    assert fe.clock.spent("idle") > 0.0 and fe.clock.spent("compute") > 0.0
    tracer.assert_matches_clock(fe.clock)
    fe.clock.assert_conserved()


@pytest.mark.parametrize("backend", BACKENDS)
def test_request_spans_carry_exact_stage_identities(backend):
    fe, st, tracer = _traced_run(backend)
    reqs = tracer.find(kind="request")
    served = [sp for sp in reqs if not sp.attrs["shed"]]
    assert len(served) == len(st.request_latencies)
    for sp in served:
        at = sp.attrs
        assert at["queue_s"] + at["service_s"] == at["latency_s"]
        assert at["fetch_s"] + at["compute_s"] == at["service_s"]
        assert sp.end_t - sp.start_t == pytest.approx(at["latency_s"])
    assert sorted(sp.attrs["latency_s"] for sp in served) \
        == sorted(st.request_latencies)
    assert tracer.find(name="dispatch", kind="frontend")
    assert tracer.find(name="fetch", kind="engine")
    assert tracer.find(name="schedule", kind="policy")


def _bench_style_metrics(fe, st):
    lat = np.asarray(st.request_latencies, dtype=np.float64)
    return {
        "offered": st.offered_requests, "served": len(lat),
        "shed": st.shed_requests, "slo_misses": st.slo_misses,
        "goodput": st.goodput, "batches": st.batches,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "hit_ratio": fe.engine.server.pool.hit_ratio,
        "clock_ms": fe.clock.now * 1e3,
    }


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracing_on_vs_off_is_bit_identical(backend):
    fe_on, st_on, _ = _traced_run(backend)
    fe_off, st_off, _ = _traced_run(backend, tracer=NULL_TRACER)
    assert json.dumps(_bench_style_metrics(fe_on, st_on), sort_keys=True) \
        == json.dumps(_bench_style_metrics(fe_off, st_off), sort_keys=True)
    assert fe_on.results.keys() == fe_off.results.keys()
    for rid in fe_on.results:
        np.testing.assert_array_equal(fe_on.results[rid],
                                      fe_off.results[rid])
    assert fe_on.clock.now == fe_off.clock.now
    assert fe_on.clock.channels == fe_off.clock.channels


def test_chrome_trace_export_validates_and_roundtrips(tmp_path):
    fe, st, tracer = _traced_run(BACKENDS[1])
    doc = to_chrome_trace(tracer, clock=fe.clock)
    assert validate_chrome_trace(doc) == []
    other = doc["otherData"]
    assert other["tracer_channel_seconds"] == other["clock_channels"]
    names = {ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"channel/storage", "channel/compute", "channel/idle",
            "requests"} <= names
    cj = write_trace(str(tmp_path / "t.json"), tracer, clock=fe.clock)
    jl = write_trace(str(tmp_path / "t.jsonl"), tracer)
    from_chrome, from_jsonl = load_trace(cj), load_trace(jl)
    assert len(from_chrome) == len(from_jsonl) == len(tracer.spans())
    for spans in (from_chrome, from_jsonl):
        served = [s for s in spans if s["kind"] == "request"
                  and not s["attrs"]["shed"]]
        assert served
        for s in served:
            at = s["attrs"]
            assert at["queue_s"] + at["service_s"] == at["latency_s"]
    report = subprocess.run([sys.executable,
                             str(ROOT / "scripts" / "trace_report.py"), cj],
                            capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stdout + report.stderr
    assert "exact identities OK" in report.stdout


def test_every_serve_stat_has_exactly_one_report_line(capsys):
    """REPORT_FIELDS is the audit: every field of the port's ServeStats
    maps to one [tag] line that the port's launch/serve.py prints with
    the mapped key; the six [shards] fields appear on the line a 2-shard
    CLI run prints, with the values of its server's stats."""
    from repro_torch.launch.serve import main as serve_main
    fields = {f.name for f in dataclasses.fields(ServeStats)}
    assert set(REPORT_FIELDS) == fields
    known_tags = {"serve", "device", "transfer", "prefetch", "shards",
                  "faults", "traffic"}
    src = (ROOT / "src/repro_torch/launch/serve.py").read_text()
    for field, (tag, key) in REPORT_FIELDS.items():
        assert tag in known_tags, field
        assert f"[{tag}]" in src, f"{field}: no [{tag}] line"
        for k in key.split("/"):
            assert k in src, f"{field}: key {k!r} not printed"
    _, server = serve_main(["--shards", "2", "--placement", "hash",
                            "--kernel-mode", "torch", "--models", "4",
                            "--batches", "12"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[shards]")]
    assert len(line) == 1, line
    s = server.stats
    printed = {
        "shard_batches": f"batches_per_shard="
                         f"{dict(sorted(s.shard_batches.items()))}",
        "borrow_pages": f"borrows={s.borrow_pages}",
        "borrow_mirror_hits": f"mirror={s.borrow_mirror_hits}",
        "borrow_store_faults": f"owner_faults={s.borrow_store_faults}",
        "borrow_coalesced": f"coalesced={s.borrow_coalesced}",
        "borrow_seconds": f"borrow={s.borrow_seconds * 1e3:.2f}ms"}
    shards = sorted(f for f, (tag, _) in REPORT_FIELDS.items()
                    if tag == "shards")
    assert shards == sorted(printed)
    for field, text in printed.items():
        assert REPORT_FIELDS[field][1] in text
        assert text in line[0], (field, text, line[0])
    assert s.borrow_pages > 0


def test_cli_trace_and_report_json(tmp_path, capsys):
    """--trace and --report-json on the host simulator: the trace
    validates and the report holds every ServeStats counter."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.obs import validate_chrome_trace as validate
    trace, report = tmp_path / "t.json", tmp_path / "r.json"
    serve_main(["--backend", "numpy", "--models", "3", "--vocab", "512",
                "--traffic", "rate=300,requests=30,slo_ms=100,max_batch=4",
                "--trace", str(trace), "--report-json", str(report)])
    out = capsys.readouterr().out
    assert "[trace] spans=" in out and "[report-json] metrics=" in out
    assert validate(json.loads(trace.read_text())) == []
    snap = json.loads(report.read_text())
    for f in dataclasses.fields(ServeStats):
        assert f"serve.{f.name}" in snap
    assert "clock.now" in snap
