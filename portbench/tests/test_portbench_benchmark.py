"""``BENCHMARK.json`` keeps the benchmark's contract, and every name in it
resolves to a file of its own under ``portbench``."""
import json
import re

import pytest

from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def width(key):
    """A width the contract never lets a cut name: a size, head, state,
    expansion or experts per token (the vocabulary is a slice, not one)."""
    return (key.endswith(("_size", "_dim", "_rank")) and key != "vocab_size") \
        or any(w in key for w in ("expand", "state", "experts_per_tok",
                                  "num_attention_heads", "num_key_value"))


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check, with 24 cells, fits its 43,200 seconds
    full = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert full <= 43200 and cells <= 24


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(c["name"]) and line(c["why"]) and line(c["source"])
    f = json.loads((ROOT / c["file"]).read_text())
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert f["name"] == c["name"]
    assert sorted(c["reduced"]) == sorted(f["published"])
    for key in c["reduced"]:
        assert NAME.fullmatch(key) and f[key] != f["published"][key]
        assert not width(key)
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
    assert w["chips"] == 1 and line(w["why"])
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or w["name"] in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any("workloads" not in m or w["name"] in m["workloads"]
               for m in BENCH["per_layer"])


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(m):
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m["name"] in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= \
            set(moved.get("workloads", cells))
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_setup_bound_and_size():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
