"""Slice 1 as a whole: the port serves a database the JAX package wrote.

The reference builds the word2vec scenario and commits it to SQLite;
``repro.db.DedupDB`` and ``repro_torch.db.DedupDB`` both open the file
and serve the same traffic — the port in its ``torch`` and ``host``
modes, the reference in ``host`` mode.  Logits must agree within 1e-5
and the buffer pools must make the same decisions (``hit_ratio``,
``pages_fetched``).  Also: weights carried across as numpy arrays
(``repro_torch.convert``), the two CLIs, and ``chip_smoke.py`` refusing
to run without a card.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTextTask as JTask
from repro.db import DedupDB as JDB
from repro.launch.serve import build_store as jbuild_store
from repro.serving.engine import StorageModel as JStorage
from repro_torch import convert
from repro_torch.db import DedupDB
from repro_torch.serving.engine import (EmbeddingServingEngine, StorageModel,
                                        WeightServer)
from repro_torch.storage import open_backend

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NUM_MODELS, BATCHES, BATCH = 4, 8, 16


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's store, heads and task, saved to SQLite."""
    task = JTask(vocab=1024, d=72, seed=3)      # d=72: ragged last stripe
    store, heads = jbuild_store(task, NUM_MODELS, block_shape=(32, 32),
                                blocks_per_page=4)
    url = f"sqlite:///{tmp_path_factory.mktemp('db') / 'models.db'}"
    store.save(url)
    return task, store, heads, url


def _traffic(task):
    rng = np.random.default_rng(11)
    out = []
    for b in range(BATCHES):
        v = int(rng.integers(0, NUM_MODELS))
        docs, _ = task.sample(BATCH, variant=v, seed=200 + b)
        out.append((f"word2vec-v{v}", docs))
    return out


def _serve(engine, traffic):
    logits = []
    for model, docs in traffic:
        engine.submit(model, docs)
        engine.run(max_batches=1)
        logits.append(engine.last_logits.copy())
    return logits


def _cap(store, traffic):
    """Half the store's pages, but at least one batch's pinned group."""
    planner = WeightServer(store, 2, backend="numpy")
    worst = max(len(planner.embedding_rows_pages(m, "embedding",
                                                 np.unique(d)))
                for m, d in traffic)
    cap = max(store.num_pages() // 2, worst)
    assert cap < store.num_pages()               # pages still churn
    return cap


def test_port_serves_the_reference_sqlite_store(reference):
    task, store, heads, url = reference
    traffic = _traffic(task)
    jdb = JDB.open(url)
    jeng = jdb.serve_embedding(heads, capacity_pages=_cap(store, traffic),
                               storage=JStorage("dram"),
                               compute_backend="device", kernel_mode="host",
                               scheduler="dedup_affinity", overlap=True)
    want = _serve(jeng, traffic)
    runs = {}
    for km in ("torch", "host"):
        db = DedupDB.open(url)
        np.testing.assert_array_equal(db.store.page_pool(),
                                      jdb.store.page_pool())
        eng = db.serve_embedding(heads, capacity_pages=_cap(store, traffic),
                                 storage=StorageModel("dram"),
                                 kernel_mode=km, scheduler="dedup_affinity",
                                 overlap=True)
        runs[km] = (_serve(eng, traffic), eng)
        db.close()
    jdb.close()
    for km, (got, eng) in runs.items():
        assert eng.stats.device_batches == BATCHES, km
        assert eng.stats.dense_fallbacks == 0, km
        for a, b in zip(want, got):
            np.testing.assert_allclose(a, b, atol=1e-5)
        assert eng.server.pool.hit_ratio == jeng.server.pool.hit_ratio
        assert eng.stats.pages_fetched == jeng.stats.pages_fetched
        assert eng.stats.transfer_pages == jeng.stats.transfer_pages


def test_store_from_arrays_serves_the_same_logits(reference):
    """Weights carried across as numpy arrays rebuild a byte-identical
    store that serves the reference's logits."""
    task, store, heads, _ = reference
    cfg = convert.store_config_from_dict(dataclasses.asdict(store.cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(store.cfg)
    arrays = {m: {"embedding":
                  task.variant_embedding(int(m.rsplit("-v", 1)[1]))}
              for m in sorted(store.dedup.models)}
    port_store = convert.store_from_arrays(cfg, arrays)
    np.testing.assert_array_equal(port_store.page_pool(), store.page_pool())
    traffic = _traffic(task)
    want = [store.materialize(m, "embedding")[d].mean(axis=1) @ heads[m]
            for m, d in traffic]
    server = WeightServer(port_store, _cap(store, traffic),
                          storage=StorageModel("dram"), kernel_mode="torch")
    got = _serve(EmbeddingServingEngine(server, heads), traffic)
    for a, b in zip(want, got):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_port_db_roundtrip_and_unported_entry_points(tmp_path):
    """The port commits and reopens its own database; the LM engine and
    sharded slabs say which slice brings them."""
    from repro_torch.data.pipeline import SyntheticTextTask
    from repro_torch.launch.serve import build_store
    task = SyntheticTextTask(vocab=256, d=32, seed=0)
    store, heads = build_store(task, 2, block_shape=(32, 32),
                               blocks_per_page=4)
    db = DedupDB.open(f"sqlite:///{tmp_path / 'port.db'}")
    for m in sorted(store.dedup.models):
        db.register(m, {"embedding": store.materialize(m, "embedding")})
    db.commit()
    db.close()
    live = DedupDB.open(f"sqlite:///{tmp_path / 'port.db'}")
    assert live.models() == sorted(store.dedup.models)
    with pytest.raises(NotImplementedError, match="slice 2"):
        live.serve_lm({}, {})
    with pytest.raises(NotImplementedError, match="later slice"):
        live.weight_server(shards=2, kernel_mode="torch")
    if not torch.cuda.is_available():       # the default is the card
        with pytest.raises(RuntimeError):
            live.serve_embedding(heads, storage=StorageModel("dram"))
    live.close()


def _cli(module, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *flags],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_numpy_backend_matches_reference_cli():
    flags = ["--backend", "numpy", "--models", "3", "--batches", "12",
             "--vocab", "1024", "--capacity-pages", "3", "--seed", "5",
             "--scheduler", "dedup_affinity", "--overlap", "--prefetch"]
    port = _cli("repro_torch.launch.serve", *flags)
    ref = _cli("repro.launch.serve", *flags)

    def serve_line(text):
        line = next(l for l in text.splitlines() if l.startswith("[serve]"))
        return (re.search(r"hit_ratio=(\S+)", line).group(1),
                re.search(r" pages=(\S+)", line).group(1),
                re.search(r"batches=(\S+)", line).group(1))

    assert serve_line(port) == serve_line(ref)
    store_line = [l for l in port.splitlines() if l.startswith("[store]")]
    assert store_line == [l for l in ref.splitlines()
                          if l.startswith("[store]")]


def test_cli_device_path_on_cpu_from_sqlite(tmp_path):
    """The CLI's device backend means the card: without one it exits
    non-zero instead of serving from the CPU.  The same device path runs
    on the CPU when a caller asks ``DedupDB`` for the torch kernel mode,
    out of a database the port committed."""
    from repro_torch.data.pipeline import SyntheticTextTask
    from repro_torch.launch.serve import build_store
    if not torch.cuda.is_available():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--models",
             "2", "--batches", "2", "--vocab", "512"],
            capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
        assert out.returncode != 0
        assert "[serve]" not in out.stdout
        assert "no CUDA device" in out.stderr
    task = SyntheticTextTask(vocab=512, seed=0)
    store, heads = build_store(task, 2)
    url = f"sqlite:///{tmp_path / 'cli.db'}"
    DedupDB(store, open_backend(url)).commit()
    traffic = [(f"word2vec-v{b % 2}",
                task.sample(32, variant=b % 2, seed=100 + b)[0])
               for b in range(4)]
    db = DedupDB.open(url)
    eng = db.serve_embedding(heads, capacity_pages=4, kernel_mode="torch",
                             scheduler="dedup_affinity", overlap=True)
    got = _serve(eng, traffic)
    db.close()
    assert eng.server.device_pool.mode() == "torch"
    assert eng.stats.device_batches == 4 and eng.stats.dense_fallbacks == 0
    assert eng.stats.transfer_pages > 0
    for (m, docs), b in zip(traffic, got):
        want = store.materialize(m, "embedding")[docs].mean(axis=1) @ heads[m]
        np.testing.assert_allclose(want, b, atol=1e-5)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """Without CUDA the smoke script exits non-zero and prints no
    result; copied alone into an empty directory it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=120, cwd=cwd)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
