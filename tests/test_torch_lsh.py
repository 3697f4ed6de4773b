"""Slice 3: the Alg.-1 index build with its signature step in the port,
held against the JAX package on the CPU.

Signatures are compared under the edge criterion: equal, except hashes
whose exact value ``(x . P + b) / r``, taken in fp64, lies within 1e-4 of
an integer (``kernels.ref.lsh_edges``).  There two fp32 summation orders
may floor to neighbouring buckets, and they do: the reference's own
batched and per-block numpy signatures disagree at such edges.  Every
other mismatch fails.  Stores are compared exactly: block maps, page
packing and the committed pages' content hashes must be equal.  The
Pallas kernel runs in interpret mode, as ``tests/test_kernels.py`` runs
it on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JDedupConfig
from repro.core import Deduplicator as JDeduplicator
from repro.core import LSHConfig as JLSHConfig
from repro.core import ModelStore as JModelStore
from repro.core import StoreConfig as JStoreConfig
from repro.core.lsh import L2LSH as JL2LSH
from repro.data.pipeline import SyntheticTextTask as JTask
from repro.db import DedupDB as JDB
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import build_store as jbuild_store
from repro_torch.configs import get_config, reduced
from repro_torch.core import DedupConfig, LSHConfig
from repro_torch.core.device_index import (DeviceDeduplicator, DeviceL2LSH,
                                           DeviceModelStore)
from repro_torch.core.lsh import L2LSH
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.db import DedupDB
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import build_lm_store, build_store

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

#: the reference's three test shapes (tests/test_kernels.py), one chunk
#: row of the LM stores (64x64 blocks, 64 hashes, r = 0.25) and the
#: CLI's LM store (32x32 blocks, 16 hashes, r = 4)
SHAPES = [(16, 64, 16, 2.0), (33, 100, 24, 4.0), (128, 512, 128, 1.0),
          (256, 4096, 64, 0.25), (256, 1024, 16, 4.0)]


def _inputs(n, dim, nh, r, seed=0):
    """Blocks at the LM weights' init scale (std 0.02) for the stores'
    widths, unit normal for the reference's shapes."""
    rng = np.random.default_rng(seed)
    scale = 0.02 if dim >= 1024 else 1.0
    blocks = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    proj = rng.standard_normal((dim, nh)).astype(np.float32)
    bias = (rng.random(nh) * r).astype(np.float32)
    return blocks, proj, bias


def _edges(blocks, proj, bias, r):
    flat = np.asarray(blocks, np.float32).reshape(len(blocks), -1)
    return ref.lsh_edges(torch.from_numpy(flat), torch.from_numpy(proj),
                         torch.from_numpy(bias), r).numpy()


def _assert_agree(got, want, edges):
    assert got.shape == want.shape and got.dtype == np.int32
    off = (got != want) & ~edges
    assert not off.any(), f"{int(off.sum())} hashes differ off the edges"


@pytest.mark.parametrize("n,dim,nh,r", SHAPES)
def test_plain_signature_matches_the_jax_kernel(n, dim, nh, r):
    blocks, proj, bias = _inputs(n, dim, nh, r)
    args = [torch.from_numpy(a) for a in (blocks, proj, bias)]
    got = ref.lsh_signature(*args, r).numpy()
    edges = _edges(blocks, proj, bias, r)
    jargs = [jnp.asarray(a) for a in (blocks, proj, bias)]
    _assert_agree(got, np.asarray(jops.lsh_signature(*jargs, r=r)), edges)
    _assert_agree(got, np.asarray(jref.lsh_signature(*jargs, r)), edges)
    # on the CPU the wrapper is the plain version
    assert np.array_equal(ops.lsh_signature(*args, r).numpy(), got)


def _tf32_halves(a):
    """The tf32x3 body's split of fp32 values: hi = a with its low 13
    mantissa bits cleared, lo = a - hi (exact) rounded to tf32, to
    nearest with ties away from zero (``cvt.rna.tf32.f32``)."""
    hi = (a.view(torch.int32) & -8192).view(torch.float32)
    lo = a - hi
    lo = ((lo.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    return hi, lo


#: the reference's three shapes and an LM-like chunk row (x std 0.02,
#: 64 hashes, r = 0.25), as the tf32x3 body takes them
TF32X3_SHAPES = SHAPES[:3] + [(512, 4096, 64, 0.25)]


@pytest.mark.parametrize("n,dim,nh,r", TF32X3_SHAPES)
def test_tf32x3_split_agrees_with_the_jax_kernel(n, dim, nh, r):
    """Plain-torch emulation of the tf32x3 body's arithmetic:
    x_hi P_hi + x_hi P_lo + x_lo P_hi in fp32, then the bias, the IEEE
    division by r and the floor.  Held against the Pallas kernel
    (interpret mode) and numpy off the 1e-4 bucket edges; and the
    split's own error (taken in fp64, against the exact product) stays
    under a quarter of that tolerance, in buckets."""
    blocks, proj, bias = _inputs(n, dim, nh, r)
    x, p, b = (torch.from_numpy(a) for a in (blocks, proj, bias))
    (xh, xl), (ph, pl) = _tf32_halves(x), _tf32_halves(p)
    split = xh @ ph + xh @ pl + xl @ ph
    got = torch.floor((split + b) / r).to(torch.int32).numpy()
    edges = _edges(blocks, proj, bias, r)
    jargs = [jnp.asarray(a) for a in (blocks, proj, bias)]
    _assert_agree(got, np.asarray(jops.lsh_signature(*jargs, r=r)), edges)
    _assert_agree(got, np.floor((blocks @ proj + bias) / r).astype(np.int32),
                  edges)
    d = [t.double() for t in (xh, xl, ph, pl, x, p)]
    exact_split = d[0] @ d[2] + d[0] @ d[3] + d[1] @ d[2]
    err = float((exact_split - d[4] @ d[5]).abs().max()) / r
    assert err < ref.LSH_EDGE_TOL / 4, err


@pytest.mark.parametrize("block,cfg", [
    ((32, 32), dict(num_bands=8, rows_per_band=2, r=4.0,
                    collision_threshold=6)),          # the CLI's LM store
    ((64, 64), dict(r=0.25)),                        # chip_smoke's LM store
    ((16, 8), dict(r=1.0, seed=3)),
])
def test_device_lsh_matches_the_reference_l2lsh(block, cfg):
    dim = block[0] * block[1]
    jl = JL2LSH(dim, JLSHConfig(**cfg))
    host = L2LSH(dim, LSHConfig(**cfg))
    dl = DeviceL2LSH(host, mode="torch")
    for a, b in ((dl.proj, jl.proj), (dl.bias, jl.bias)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    rng = np.random.default_rng(1)
    blocks = (rng.standard_normal((300,) + block) * 0.02).astype(np.float32)
    got = dl.signatures(blocks)
    edges = _edges(blocks, dl.proj, dl.bias, dl.cfg.r)
    _assert_agree(got, jl.signatures(blocks), edges)
    per_block = np.stack([jl.signatures(b[None])[0] for b in blocks])
    _assert_agree(got, per_block, edges)
    assert dl.stats.blocks == 300 and dl.stats.launches == 0
    # host mode is the reference's routine, bit for bit
    assert np.array_equal(DeviceL2LSH(host, "host").signatures(blocks),
                          jl.signatures(blocks))
    with pytest.raises(ValueError, match="block dim"):
        dl.signatures(blocks[:, :, :4])


def _manifest(store, url):
    m = store.save(url)
    return [(p["hash"], p["blocks"]) for p in m["pages"]]


def _assert_same_store(store, jstore, tmp_path, tag):
    assert sorted(store.dedup.models) == sorted(jstore.dedup.models)
    for m, res in jstore.dedup.models.items():
        assert sorted(res.tensors) == sorted(store.dedup.models[m].tensors)
        for t, e in res.tensors.items():
            np.testing.assert_array_equal(
                store.dedup.models[m].tensors[t].block_map, e.block_map,
                err_msg=f"{m}/{t}")
    assert store.dedup.num_distinct == jstore.dedup.num_distinct
    assert store.packing.pages == jstore.packing.pages
    assert _manifest(store, f"sqlite:///{tmp_path / f'{tag}-port.db'}") \
        == _manifest(jstore, f"sqlite:///{tmp_path / f'{tag}-jax.db'}")


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_embedding_store_matches_the_reference(tmp_path, mode):
    jstore, _ = jbuild_store(JTask(vocab=2048, d=72, seed=3), 4,
                             block_shape=(32, 32), blocks_per_page=4)
    store, _ = build_store(SyntheticTextTask(vocab=2048, d=72, seed=3), 4,
                           block_shape=(32, 32), blocks_per_page=4,
                           index_mode=mode)
    _assert_same_store(store, jstore, tmp_path, mode)
    st = store.dedup.index_stats
    assert st.blocks == sum(r.total_blocks
                            for r in store.dedup.models.values())
    assert st.build_seconds > 0 and st.launches == 0


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_lm_store_matches_the_reference(tmp_path, mode):
    """The CLI's LM store: the port's build against the reference
    CLI's store configuration fed the same exported weights."""
    store, names, lm = build_lm_store(reduced(get_config("deepseek-7b")), 2,
                                      seed=0, index_mode=mode)
    jstore = JModelStore(JStoreConfig(
        dedup=JDedupConfig(block_shape=(32, 32),
                           lsh=JLSHConfig(num_bands=8, rows_per_band=2,
                                          r=4.0, collision_threshold=6),
                           validate=False),
        blocks_per_page=8))
    for v, name in enumerate(names):
        delta = 0.0 if v == 0 else 1e-5 * v
        jstore.register(name, {k: t + delta for k, t in lm.tensors.items()})
    _assert_same_store(store, jstore, tmp_path, mode)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b", "phi-3-vision-4.2b"])
def test_family_lm_store_matches_the_reference(tmp_path, arch):
    """``build_lm_store`` takes every decoder-only family: the same store
    as the reference's configuration fed the same weights; an
    encoder-decoder config is refused."""
    store, names, lm = build_lm_store(reduced(get_config(arch)), 2, seed=0,
                                      index_mode="torch")
    assert any("/mamba/" in k or "/moe/" in k for k in lm.tensors) \
        or arch.startswith("phi")
    jstore = JModelStore(JStoreConfig(
        dedup=JDedupConfig(block_shape=(32, 32),
                           lsh=JLSHConfig(num_bands=8, rows_per_band=2,
                                          r=4.0, collision_threshold=6),
                           validate=False),
        blocks_per_page=8))
    for v, name in enumerate(names):
        delta = 0.0 if v == 0 else 1e-5 * v
        jstore.register(name, {k: t + delta for k, t in lm.tensors.items()})
    _assert_same_store(store, jstore, tmp_path, arch)
    with pytest.raises(ValueError, match="decoder-only"):
        build_lm_store(reduced(get_config("whisper-small")), 1,
                       index_mode="torch")


def _updated_embedding(task, variant):
    """A fine-tune of one variant: a third of its rows moved."""
    x = task.variant_embedding(variant).copy()
    rng = np.random.default_rng(7)
    rows = len(x) // 3
    x[:rows] += rng.standard_normal((rows, x.shape[1])).astype(np.float32)
    return x


@pytest.mark.parametrize("approach", [2, 1])
def test_reopen_and_update_matches_the_reference(tmp_path, approach):
    """A committed store reopened live, re-indexed (rebuild_index) and
    updated (Sec. 7.6): the port in torch mode and the reference give
    the same block maps and commit the same pages."""
    task = JTask(vocab=1024, d=72, seed=5)
    jstore, _ = jbuild_store(task, 3, block_shape=(32, 32),
                             blocks_per_page=4)
    urls = {k: f"sqlite:///{tmp_path / f'{k}.db'}" for k in ("jax", "port")}
    for url in urls.values():
        jstore.save(url)
    new = {"embedding": _updated_embedding(task, 1)}
    jdb = JDB.open(urls["jax"])
    jres = jdb.update("word2vec-v1", new, approach=approach)
    db = DedupDB.open(urls["port"], index_mode="torch")
    res = db.update("word2vec-v1", new, approach=approach)
    assert res.deduped_blocks == jres.deduped_blocks
    assert 0 < res.total_blocks == jres.total_blocks
    st = db.store.dedup.index_stats
    # the re-index signed every distinct block, the update the new ones
    assert st.blocks >= jstore.dedup.num_distinct + res.total_blocks
    for m, r in jdb.store.dedup.models.items():
        np.testing.assert_array_equal(
            db.store.dedup.models[m].tensors["embedding"].block_map,
            r.tensors["embedding"].block_map, err_msg=m)
    assert db.commit()["pages"] == jdb.commit()["pages"]
    db.close()
    jdb.close()


def test_validated_build_stops_where_the_reference_stops():
    """Alg. 1 with validation: once the accuracy budget is spent the
    remaining blocks are indexed as distinct (``_index_as_distinct``);
    the port's batched signatures stop at the same block."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((256, 128)).astype(np.float32)
    tensors = {"a": base, "b": base[:, :64] + 0.05}
    variant = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.02
               for k, v in tensors.items()}

    def evaluator(ts):
        drift = sum(float(np.abs(ts[k] - variant[k]).mean()) for k in ts)
        return 1.0 - drift

    kw = dict(block_shape=(16, 16), validate_every_k=8,
              accuracy_drop_threshold=0.01)
    lsh = dict(num_bands=8, rows_per_band=2, r=2.0, collision_threshold=4)
    jd = JDeduplicator(JDedupConfig(lsh=JLSHConfig(**lsh), **kw))
    pd = DeviceDeduplicator(DedupConfig(lsh=LSHConfig(**lsh), **kw),
                            index_mode="torch")
    results = []
    for d in (jd, pd):
        d.add_model("base", tensors)
        results.append(d.add_model("v1", variant, evaluator))
    jres, pres = results
    assert jres.stopped and pres.stopped
    assert 0 < jres.deduped_blocks < jres.total_blocks
    assert (pres.deduped_blocks, pres.num_validations) == \
        (jres.deduped_blocks, jres.num_validations)
    for m in ("base", "v1"):
        for t in tensors:
            np.testing.assert_array_equal(pd.models[m].tensors[t].block_map,
                                          jd.models[m].tensors[t].block_map)


def test_auto_index_mode_needs_a_card(tmp_path):
    """``auto`` signs on the card and never on the CPU: without a card
    the build raises; opening a database to serve needs no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: auto would run the kernel")
    with pytest.raises(RuntimeError, match="index_mode='auto'"):
        build_store(SyntheticTextTask(vocab=256, d=32, seed=0), 2)
    url = f"sqlite:///{tmp_path / 'auto.db'}"
    db = DedupDB.open(url)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        db.register("m", {"w": np.ones((64, 64), np.float32)})
    host = DedupDB.open(url, index_mode="host")
    host.register("m", {"w": np.ones((64, 64), np.float32)})
    host.commit()
    assert DedupDB.open(url).models() == ["m"]
    with pytest.raises(ValueError, match="unknown index_mode"):
        DeviceModelStore(index_mode="gpu")


def test_cli_index_modes_build_the_reference_store():
    """``--index-mode torch`` builds the store the reference CLI builds
    (its ``[store]`` line) and reports the signature step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    flags = ["--backend", "numpy", "--models", "3", "--batches", "2",
             "--vocab", "1024"]

    def run(module, *extra):
        out = subprocess.run([sys.executable, "-m", module, *flags, *extra],
                             capture_output=True, text=True, env=env,
                             timeout=300, cwd=ROOT)
        assert out.returncode == 0, out.stdout + out.stderr
        return {l.split()[0]: l for l in out.stdout.splitlines()
                if l.startswith("[")}

    port = run("repro_torch.launch.serve", "--index-mode", "torch")
    assert port["[store]"] == run("repro.launch.serve")["[store]"]
    index = port["[index]"]
    assert "mode=torch" in index and "launches=0" in index
    assert int(re.search(r"blocks=(\d+)", index).group(1)) > 0
