"""Warm-restart serving of the port (DESIGN.md §11), and its parity with
the JAX package.

Ports of the warm-restart tests of ``tests/test_recovery.py``: a run
killed after k dispatches and restored into a fresh engine from the
snapshot alone serves every request exactly once with bit-equal results;
in-flight requests are re-admitted; a restore needs every referenced id;
the CLI's ``--snapshot`` / ``--kill-after`` on the host simulator and its
flag validation.  The port's engine runs on its host simulator and on its
device path in the ``torch`` kernel mode.

Parity: after k dispatches the port's ``snapshot()`` equals the
reference's key for key (but the engine's wall-clock compute seconds,
which each package measures on its own host), and a snapshot the JAX
frontend wrote restores into the port's frontend and finishes with the
reference's results.  The all-flags composition run (traffic + faults
+ ``--shards 2`` + trace + report-json) runs through the CLI in the
``torch`` kernel mode.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.launch.serve import build_store as jbuild_store
from repro.data.pipeline import SyntheticTextTask as JTask
from repro.serving import BatchComputeModel as JComputeModel
from repro.serving import EmbeddingServingEngine as JEngine
from repro.serving import OpenLoopTraffic as JTraffic
from repro.serving import ServingFrontend as JFrontend
from repro.serving import StorageModel as JStorage
from repro.serving import WeightServer as JServer
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.launch.serve import build_store
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving import (BatchComputeModel, EmbeddingServingEngine,
                                 OpenLoopTraffic, ServingFrontend,
                                 StorageModel, WeightServer)

torch.set_num_threads(2)

BACKENDS = [("numpy", "auto"), ("device", "torch")]


def _scenario(num_models=4, vocab=512):
    task = SyntheticTextTask(vocab=vocab, d=32, seed=0)
    store, heads = build_store(task, num_models, block_shape=(32, 32),
                               blocks_per_page=4, index_mode="host")
    return task, store, heads


def _payload(task):
    def fn(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(2, variant=v, seed=900 + rid)
        return docs
    return fn


def _engine(store, heads, backend):
    server = WeightServer(store, max(2, store.num_pages() // 2),
                          storage=StorageModel("dram"), backend=backend[0],
                          kernel_mode=backend[1])
    return EmbeddingServingEngine(server, heads, scheduler="fifo")


def _frontend(store, heads, backend=BACKENDS[0], **kw):
    return ServingFrontend(_engine(store, heads, backend), max_batch=4,
                           compute_model=BatchComputeModel(), **kw)


def _gen(task, heads):
    return OpenLoopTraffic(sorted(heads), rate=300.0, zipf_alpha=1.1,
                           slo_s=0.5, seed=5, payload_fn=_payload(task))


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_restart_is_bit_exact_and_at_most_once(tmp_path, backend):
    task, store, heads = _scenario()
    n = 60
    fe0 = _frontend(store, heads, backend)
    st0 = fe0.run(_gen(task, heads).generate(n))
    golden = dict(fe0.results)
    assert len(golden) == n

    snap_path = str(tmp_path / "fe.json")
    fe1 = _frontend(store, heads, backend, snapshot_path=snap_path)
    fe1.run(_gen(task, heads).generate(n), max_dispatches=4)
    served_before = dict(fe1.results)
    assert 0 < len(served_before) < n
    # simulated process death: only the snapshot file survives
    with open(snap_path) as f:
        snap = json.load(f)
    task2, store2, heads2 = _scenario()
    fe2 = ServingFrontend.restore(_engine(store2, heads2, backend), snap,
                                  _gen(task2, heads2).generate(n),
                                  compute_model=BatchComputeModel(),
                                  snapshot_path=snap_path)
    assert fe2.ledger.readmitted > 0
    st2 = fe2.run(_gen(task2, heads2).generate(n))
    fe2.assert_ledger_conserved()
    assert not set(served_before) & set(fe2.results)
    combined = {**served_before, **fe2.results}
    assert set(combined) == set(golden)
    for rid, out in golden.items():
        assert np.array_equal(combined[rid], out), f"rid {rid} diverged"
    assert st2.offered_requests == st0.offered_requests == n
    assert len(st2.request_latencies) == n
    assert fe2.clock.now >= fe0.clock.now


@pytest.mark.parametrize("backend", BACKENDS)
def test_in_flight_requests_are_readmitted_not_lost(tmp_path, backend):
    task, store, heads = _scenario()
    n = 40
    snap_path = str(tmp_path / "fe.json")
    fe1 = _frontend(store, heads, backend, snapshot_path=snap_path)
    engine1 = fe1.engine
    orig_run = engine1.run
    calls = {"n": 0}

    def dying_run(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated crash mid-compute")
        return orig_run(*a, **kw)

    engine1.run = dying_run
    with pytest.raises(RuntimeError, match="mid-compute"):
        fe1.run(_gen(task, heads).generate(n))
    with open(snap_path) as f:
        snap = json.load(f)
    assert snap["ledger"]["in_flight"]
    in_flight = set(snap["ledger"]["in_flight"])
    assert not in_flight & set(snap["ledger"]["served"])

    task2, store2, heads2 = _scenario()
    fe2 = ServingFrontend.restore(_engine(store2, heads2, backend), snap,
                                  _gen(task2, heads2).generate(n),
                                  compute_model=BatchComputeModel(),
                                  snapshot_path=snap_path)
    assert fe2.ledger.readmitted >= len(in_flight)
    fe2.run(_gen(task2, heads2).generate(n))
    fe2.assert_ledger_conserved()
    led = fe2.ledger
    assert in_flight <= (led.served | led.shed)
    assert len(led.served) + len(led.shed) == len(led.offered) == n


def test_restore_requires_every_referenced_rid():
    task, store, heads = _scenario()
    fe = _frontend(store, heads)
    fe.run(_gen(task, heads).generate(20))
    snap = fe.snapshot()
    snap["ledger"]["in_flight"] = [19]
    with pytest.raises(KeyError):
        ServingFrontend.restore(fe.engine, snap, [])


# ----------------------------------------------------------- launcher ----
def test_serve_cli_kill_then_resume(tmp_path, capsys):
    snap = str(tmp_path / "fe.json")
    argv = ["--backend", "numpy", "--traffic",
            "rate=400,requests=40,slo_ms=200,max_batch=4",
            "--models", "4", "--vocab", "512", "--snapshot", snap]
    serve_main(argv + ["--kill-after", "3"])
    out1 = capsys.readouterr().out
    assert "[restart] stopped after 3 dispatches" in out1
    assert os.path.exists(snap)
    serve_main(argv)
    out2 = capsys.readouterr().out
    assert "[restart] resumed from" in out2
    assert "readmitted=" in out2
    line = [ln for ln in out2.splitlines() if ln.startswith("[traffic]")][0]
    kv = dict(p.split("=", 1) for p in line.split()[1:] if "=" in p)
    assert int(kv["offered"]) == 40
    assert int(kv["served"]) + int(kv["shed"]) == 40


def test_serve_cli_flag_validation():
    with pytest.raises(SystemExit, match="--snapshot requires --traffic"):
        serve_main(["--snapshot", "/tmp/x.json"])
    with pytest.raises(SystemExit, match="--kill-after requires"):
        serve_main(["--traffic", "requests=5", "--kill-after", "1"])
    with pytest.raises(SystemExit, match="--shards > 1 requires"):
        serve_main(["--shards", "2", "--backend", "numpy"])


def test_composition_all_flags_together(tmp_path, capsys):
    """One launcher run with traffic + faults + 2 shards + trace +
    report-json at once (the device path in the ``torch`` kernel mode):
    every report line prints, the virtual clock conserves (asserted
    inside fe.run / _export_obs), and the exported trace validates."""
    from repro_torch.obs import validate_chrome_trace
    trace = str(tmp_path / "trace.json")
    report = str(tmp_path / "report.json")
    serve_main([
        "--store-url", f"sqlite:///{tmp_path / 'm.db'}",
        "--faults", "transient=0.05,seed=7",
        "--traffic", "rate=300,requests=40,slo_ms=200,max_batch=4",
        "--shards", "2", "--backend", "device", "--kernel-mode", "torch",
        "--models", "4", "--vocab", "512",
        "--trace", trace, "--report-json", report])
    out = capsys.readouterr().out
    for tag in ("[store-url]", "[faults]", "[shards]", "[traffic]",
                "[serve]", "[trace]", "[report-json]"):
        assert any(ln.startswith(tag) for ln in out.splitlines()), \
            f"missing report line {tag}:\n{out}"
    assert "mode=torch" in out
    with open(trace) as f:
        assert validate_chrome_trace(json.load(f)) == []
    with open(report) as f:
        snap = json.load(f)
    assert any(k.startswith("serve.") for k in snap)
    assert any(k.startswith("clock.") for k in snap)


# ------------------------------------------------------ parity with JAX --
def _jax_side(n_models=4):
    """The reference's scenario and frontend factory (numpy backend, as
    its own recovery tests run it)."""
    task = JTask(vocab=512, d=32, seed=0)
    store, heads = jbuild_store(task, n_models, block_shape=(32, 32),
                                blocks_per_page=4)

    def engine():
        server = JServer(store, max(2, store.num_pages() // 2),
                         storage=JStorage("dram"))
        return JEngine(server, heads, scheduler="fifo")

    def gen():
        return JTraffic(sorted(heads), rate=300.0, zipf_alpha=1.1,
                        slo_s=0.5, seed=5, payload_fn=_payload(task))
    return engine, gen


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [2, 5])
def test_snapshot_after_k_dispatches_equals_the_reference(backend, k):
    jengine, jgen = _jax_side()
    jfe = JFrontend(jengine(), max_batch=4, compute_model=JComputeModel())
    jfe.run(jgen().generate(60), max_dispatches=k)
    task, store, heads = _scenario()
    fe = _frontend(store, heads, backend)
    fe.run(_gen(task, heads).generate(60), max_dispatches=k)
    want, got = jfe.snapshot(), fe.snapshot()
    # the one wall-clock quantity: each engine times its own compute on
    # the host (the virtual clock charges the compute model instead)
    for snap in (want, got):
        assert snap["stats"].pop("compute_seconds") > 0.0
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_jax_snapshot_restores_into_the_port(tmp_path, backend):
    """A snapshot the JAX frontend persisted, restored into the port's
    frontend on a fresh engine, finishes with the reference's results:
    every request once, the reference's uninterrupted outputs within
    1e-5 and its request-level books exactly."""
    n = 60
    jengine, jgen = _jax_side()
    golden_fe = JFrontend(jengine(), max_batch=4,
                          compute_model=JComputeModel())
    golden_st = golden_fe.run(jgen().generate(n))
    snap_path = str(tmp_path / "fe.json")
    jfe = JFrontend(jengine(), max_batch=4, compute_model=JComputeModel(),
                    snapshot_path=snap_path)
    jfe.run(jgen().generate(n), max_dispatches=4)
    served_before = dict(jfe.results)
    with open(snap_path) as f:
        snap = json.load(f)
    task, store, heads = _scenario()
    fe = ServingFrontend.restore(_engine(store, heads, backend), snap,
                                 _gen(task, heads).generate(n),
                                 compute_model=BatchComputeModel(),
                                 snapshot_path=snap_path)
    st = fe.run(_gen(task, heads).generate(n))
    fe.assert_ledger_conserved()
    assert not set(served_before) & set(fe.results)
    combined = {**served_before, **fe.results}
    assert combined.keys() == golden_fe.results.keys()
    for rid, want in golden_fe.results.items():
        np.testing.assert_allclose(combined[rid], want, atol=1e-5)
    assert st.offered_requests == golden_st.offered_requests == n
    assert len(st.request_latencies) == len(golden_st.request_latencies)
    assert st.shed_requests == golden_st.shed_requests
