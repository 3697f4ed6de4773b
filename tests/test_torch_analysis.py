"""The port's contract lints (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

* Every pass, configured alike, gives the reference pass's findings on
  the reference's fixtures under ``tests/analysis_fixtures/`` (read, not
  edited).
* Keyed to the port by ``default_passes()``, the passes find in the
  reference's own sources, with their pragmas stripped and placed at the
  port's paths, exactly what the reference's default passes find at the
  reference's paths: the keys are the reference's, renamed.
* The torch idioms the reference passes cannot see, on inline sources:
  host syncs (``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize()``, an event's ``.synchronize()``), in-place
  slab writes, and ``stop_timer`` as a channel charge.
* The port's tree is clean under its own passes.
"""
import io
import tokenize
from pathlib import Path

import pytest

import repro.analysis.passes as jpasses
import repro_torch.analysis.passes as tpasses
from repro.analysis.lint import Source as JSource
from repro_torch.analysis import run_lint
from repro_torch.analysis.lint import Source
from repro_torch.analysis.passes import (ChannelChargePass, DurabilityPass,
                                         HostSyncPass, SlabWritePass,
                                         default_passes)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "analysis_fixtures"

# each pass configured as tests/test_analysis.py configures it
FIXTURE_KW = {
    "SlabWritePass": {},
    "HostSyncPass": {"hot": {"serving/fx_hot.py": {"HotPool.gather"}}},
    "ChannelChargePass": {"path_fragment": "analysis_fixtures/serving/"},
    "FrontendClockPass": {
        "files": ("analysis_fixtures/serving/fx_frontend.py",)},
    "SpanDisciplinePass": {"path_fragment": "analysis_fixtures/"},
    "DurabilityPass": {
        "files": ("analysis_fixtures/storage/fx_durability.py",)},
    "WallClockPass": {},
    "ApiDriftPass": {"surface": ("analysis_fixtures/",)},
    "UnusedBindingPass": {},
    "SilentExceptPass": {},
}


def _key(findings):
    return [(f.line, f.col, f.name, f.message) for f in findings if f]


def _strip_pragmas(text: str) -> str:
    """``text`` without its ``# repro: ...`` comments (strings kept)."""
    lines = text.splitlines(keepends=True)
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT and "repro:" in tok.string:
            r, c = tok.start
            lines[r - 1] = lines[r - 1][:c] + lines[r - 1][c + len(
                tok.string):]
    return "".join(lines)


def test_registry_matches_the_reference():
    assert [c.__name__ for c in tpasses.ALL_PASSES] == \
        [c.__name__ for c in jpasses.ALL_PASSES]
    assert [type(p) for p in default_passes()] == list(tpasses.ALL_PASSES)
    assert set(FIXTURE_KW) == {c.__name__ for c in tpasses.ALL_PASSES}


@pytest.mark.parametrize("name", sorted(FIXTURE_KW))
def test_pass_equals_the_reference_on_its_fixtures(name):
    kw = FIXTURE_KW[name]
    mine = getattr(tpasses, name)(**kw)
    theirs = getattr(jpasses, name)(**kw)
    total = 0
    for path in sorted(FIXTURES.rglob("*.py")):
        got = _key(mine.run(Source.load(path)))
        want = _key(theirs.run(JSource.load(path)))
        assert got == want, path
        total += len(want)
    assert total > 0, f"{name} finds nothing in the fixtures"


def test_port_keys_find_what_the_reference_finds():
    """The reference's sources without pragmas: its default passes at
    ``src/repro/...`` and the port's at ``src/repro_torch/...`` agree
    finding for finding (host syncs, uncharged fetches, unjournaled
    commits at the reference's own pragma'd sites)."""
    total = 0
    for path in sorted((ROOT / "src" / "repro").rglob("*.py")):
        rel = path.relative_to(ROOT / "src" / "repro").as_posix()
        text = _strip_pragmas(path.read_text())
        want = _key(f for p in jpasses.default_passes()
                    for f in p.run(JSource(f"src/repro/{rel}", text)))
        got = _key(f for p in default_passes()
                   for f in p.run(Source(f"src/repro_torch/{rel}", text)))
        assert sorted(got) == sorted(want), rel
        total += len(want)
    assert total >= 10


# ------------------------------------------------------------ host-sync --
_HOT = '''
import torch


class EmbeddingServingEngine:
    def _infer(self, emb, ev):
        a = emb.cpu()
        b = emb.numpy()
        c = emb.tolist()
        torch.cuda.synchronize()
        ev.synchronize()
        return a, b, c

    def cold(self, emb):
        return emb.cpu().numpy()
'''

_HOT_ALLOWED = '''
import torch


class EmbeddingServingEngine:
    def _infer(self, emb, ev):
        # repro: allow-host (batch boundary)
        a = emb.cpu()
        b = emb.numpy()  # repro: allow-host (batch boundary)
        # repro: allow-host (batch boundary)
        c = emb.tolist()
        torch.cuda.synchronize()  # repro: allow-host (timing)
        ev.synchronize()  # repro: allow-host (timing)
        return a, b, c
'''


def test_host_sync_flags_torch_syncs_in_a_hot_method():
    src = Source("src/repro_torch/serving/engine.py", _HOT)
    findings = HostSyncPass().run(src)
    assert [f.line for f in findings] == [7, 8, 9, 10, 11]
    msgs = " ".join(f.message for f in findings)
    for bad in ("`cpu`", "`numpy`", "`tolist`", "`synchronize`"):
        assert bad in msgs
    assert all("EmbeddingServingEngine._infer" in f.message
               for f in findings)                 # cold() is not hot
    # the reference pass keys on repro/serving/ and bans none of them
    assert jpasses.HostSyncPass().run(
        JSource("src/repro/serving/engine.py", _HOT)) == []


def test_host_sync_silent_under_allow_host():
    src = Source("src/repro_torch/serving/engine.py", _HOT_ALLOWED)
    assert HostSyncPass().run(src) == []


# ----------------------------------------------------------- slab-write --
_SLAB = '''
def sneak(pool, slots, rows, mask, idx, value):
    pool.slab.index_copy_(0, slots, rows)
    pool.slab.index_put_((slots,), rows)
    pool.slab[0].copy_(rows[0])
    pool.slab.scatter_(0, idx, rows)
    pool.slab.index_fill_(0, slots, value)
    pool.slab.masked_scatter_(mask, rows)
    pool.cache.copy_(rows)
    return pool.slab.index_select(0, slots)
'''


def test_slab_write_flags_inplace_writes_outside_the_owners():
    findings = SlabWritePass().run(
        Source("src/repro_torch/serving/engine.py", _SLAB))
    assert [f.line for f in findings] == [3, 4, 5, 6, 7, 8]
    assert {f.name for f in findings} == {"slab-write"}
    assert "slab.index_copy_" in findings[0].message
    # the reference pass sees none of them
    assert jpasses.SlabWritePass().run(
        JSource("src/repro/serving/engine.py", _SLAB)) == []


@pytest.mark.parametrize("owner", ["transfer", "device_pool", "shard_pool"])
def test_slab_write_silent_inside_the_owners(owner):
    src = Source(f"src/repro_torch/serving/{owner}.py", _SLAB)
    assert SlabWritePass().run(src) == []
    text = (ROOT / f"src/repro_torch/serving/{owner}.py").read_text()
    assert SlabWritePass().run(
        Source(f"src/repro_torch/serving/{owner}.py", text)) == []


def test_slab_write_pragma_suppresses_an_inplace_write():
    src = Source("src/repro_torch/models/x.py",
                 "def f(slab, slots, rows):\n"
                 "    # repro: allow-slab-write (test)\n"
                 "    slab.index_copy_(0, slots, rows)\n")
    assert SlabWritePass().run(src) == []


# ------------------------------------------------------- channel-charge --
_FETCH = '''
def charged(self, pid):
    start = self.transfer.start_timer()
    page = self.store.page_array(pid)
    self.transfer.stop_timer(start, 1)
    return page


def uncharged(self, pid):
    return self.store.page_array(pid)
'''


def test_channel_charge_accepts_stop_timer():
    findings = ChannelChargePass().run(
        Source("src/repro_torch/serving/device_pool.py", _FETCH))
    assert len(findings) == 1
    assert findings[0].message.startswith("uncharged fetches")
    # the reference's charge set lacks stop_timer
    ref = jpasses.ChannelChargePass(path_fragment="repro_torch/serving/")
    assert len(ref.run(JSource("src/repro_torch/serving/device_pool.py",
                               _FETCH))) == 2


def test_channel_charge_and_durability_scoped_to_the_port():
    fetch = Source("src/repro/serving/device_pool.py", _FETCH)
    assert ChannelChargePass().run(fetch) == []
    rename = "import os\n\ndef f(a, b):\n    os.replace(a, b)\n"
    assert DurabilityPass().run(
        Source("src/repro_torch/serving/frontend.py", rename)) == []
    assert len(DurabilityPass().run(
        Source("src/repro_torch/storage/newbackend.py", rename))) == 1
    assert len(DurabilityPass().run(
        Source("src/repro_torch/core/store.py",
               "def f(con):\n    con.commit()\n"))) == 1


# ---------------------------------------------------------- the package --
def test_sanitizer_is_served_lazily_from_the_package():
    import repro_torch.analysis as analysis
    from repro_torch.analysis import sanitizer
    assert analysis.PoolSanitizer is sanitizer.PoolSanitizer
    assert analysis.enable is sanitizer.enable


def test_port_tree_is_clean():
    findings = run_lint([ROOT / "src" / "repro_torch"], default_passes())
    assert findings == [], "\n".join(str(f) for f in findings)
    assert run_lint([ROOT / "src" / "repro_torch"]) == []   # the default
