"""One module an architecture, found by a configuration's
``"architecture"`` value: ``archs/<architecture>.py``, loaded by path as
the metric readers are.  A configuration of a new architecture goes in as
files alone: its configuration, and its module here.

An architecture module defines:

* ``F32_LEAVES``: the names of the leaves the program serves in float32
  (the rest are drawn in float32 and served in bfloat16);
* ``INITS`` (optional): ``{kind: draw(shape, scale, gen, device)}``, the
  init kinds of its own that ``leaf_specs`` names beside ``weights.py``'s;
  each draws from ``gen`` after the shared draws, in ``leaf_specs`` order;
* ``dims(cfg)``: the sizes the rest of the module reads;
* ``windows(cfg)``: each layer's attention window (0 = global) in the
  order of the program's layer groups, held against the program's;
* ``attention_layers(cfg)``: ``(window, H, K, hd)`` of each layer that
  attends, in layer order: one ``flash_attention`` call each a query;
* ``leaf_specs(cfg)``: ``(path, shape, init, scale)`` of every leaf, in
  draw order (``weights.py`` has the shared pieces);
* ``program_config(cfg)``: the program's ``ModelConfig``;
* ``forward(ref, tokens, n_last)``: the plain forward of one variant, from
  ``ref.w`` keyed by path, to the last ``n_last`` positions' logits, in
  ``ref``'s precision (``reference.py`` has the shared pieces); one that
  routes picks each token's experts with ``ref.select(scores, k)``, on
  the scores the program selects on, so that the check leaves out the
  rows whose choice the float32 reference itself cannot make (``check``'s
  ``tie_margin``);
* ``block_rows(cfg, tokens)``: rows a reference block holds within
  ``check.BUDGET_BYTES``;
* ``prefill_flops(cfg, rows, tokens)``: the model operations of one
  prefill query (``counts/prefill.py`` has the shared pieces).
"""
from __future__ import annotations

import json
from pathlib import Path
from types import ModuleType
from typing import Dict

from portbench import load_module

#: the benchmark's directory this package is in
BENCH_DIR = Path(__file__).resolve().parent.parent


class Config(dict):
    """A configuration file's object; ``arch`` is the module of its
    architecture, loaded from the checkout the file was read from."""
    arch: ModuleType


def load(bench_dir: Path, name: str) -> ModuleType:
    """``<bench_dir>/archs/<name>.py``."""
    if not (bench_dir / "archs" / f"{name}.py").is_file():
        have = sorted(p.stem for p in (bench_dir / "archs").glob("*.py")
                      if p.stem != "__init__")
        raise ValueError(f"no architecture module {name!r} under "
                         f"{bench_dir / 'archs'}; have {have}")
    return load_module(bench_dir, "archs", name)


def read_config(bench_dir: Path, name: str) -> Config:
    """``<bench_dir>/configs/<name>.json``, its architecture loaded once."""
    cfg = Config(json.loads((bench_dir / "configs" / f"{name}.json")
                            .read_text()))
    cfg.arch = load(bench_dir, cfg["architecture"])
    return cfg


def of(cfg: Dict) -> ModuleType:
    """The architecture module of ``cfg``: the one it was read with, or,
    for a plain dictionary, the one of this benchmark's directory."""
    if isinstance(cfg, Config):
        return cfg.arch
    return load(BENCH_DIR, cfg["architecture"])
