"""The configuration's database, built once per checkout and then opened.

Users build a deduplicated model database once (``register`` runs Alg. 1,
``commit`` writes the pages and the manifest to SQLite) and serve from it
many times.  The first run of a configuration in a checkout builds it
into ``portbench/.cache/<config>-<digest>/``; every later run opens it.
The digest covers the configuration (but its check limits), this file,
``weights.py``, the configuration's architecture module (``archs/``) and
the program's files that decide the store's bytes, so a change to any of
them builds anew.  The build writes under ``<config>-<digest>.building``
and renames the directory when the commit is done, so a run that is cut
leaves no half store; an older digest of the same configuration is
removed.
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from portbench import archs, weights

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
#: the program's files whose code decides what a build writes
PROGRAM_FILES = ("convert.py", "db.py", "core", "storage", "kernels")


def digest(root: Path, cfg: Dict) -> str:
    """Of the configuration but its ``check`` limits, and of the code
    that decides the store's bytes."""
    files = [HERE / "store.py", HERE / "weights.py",
             Path(archs.of(cfg).__file__)]
    port = root / "src" / "repro_torch"
    for name in PROGRAM_FILES:
        p = port / name
        files += sorted(f for f in p.rglob("*") if f.is_file()
                        and f.suffix in (".py", ".cu", ".cuh")) \
            if p.is_dir() else [p]
    h = hashlib.sha256(json.dumps({k: v for k, v in cfg.items()
                                   if k != "check"}, sort_keys=True).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def url_of(path: Path) -> str:
    return f"sqlite:///{path / 'store.db'}"


def _host_tree(flat: Dict) -> Dict:
    return weights.nested({p: t.float().cpu().numpy()
                           for p, t in flat.items()})


def build(cfg: Dict, out: Path, device, index_mode: str) -> Dict:
    """Register every variant of ``cfg`` (weights drawn from its
    ``store_seed``) into a fresh SQLite database under ``out`` and
    commit it; returns what the build did."""
    from repro_torch.convert import lm_tensors
    from repro_torch.core import DedupConfig, LSHConfig, StoreConfig
    from repro_torch.db import DedupDB
    s = cfg["store"]
    store_cfg = StoreConfig(
        dedup=DedupConfig(block_shape=tuple(s["block_shape"]),
                          lsh=LSHConfig(r=s["lsh_r"]),
                          validate=s["validate"]),
        blocks_per_page=s["blocks_per_page"])
    t0 = time.perf_counter()
    variants = weights.variant_weights(cfg, device)
    t_draw = time.perf_counter() - t0
    db = DedupDB.open(url_of(out), cfg=store_cfg, index_mode=index_mode,
                      device=device)
    try:
        t0 = time.perf_counter()
        for name, flat in variants.items():
            tensors = lm_tensors(_host_tree(flat), dtype="bfloat16",
                                 per_layer=True).tensors
            db.register(name, tensors)
        t_register = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.commit()
        t_commit = time.perf_counter() - t0
        st = db.store
        info = dict(pages=st.num_pages(), distinct=st.dedup.num_distinct,
                    variant_pages={m: len(st.model_pages(m))
                                   for m in variants},
                    draw_s=t_draw, register_s=t_register,
                    commit_s=t_commit)
    finally:
        db.close()
    return info


def ensure(root: Path, cfg: Dict, device, index_mode: str,
           log: Callable[[str], None], cache: Path = CACHE
           ) -> Tuple[str, Dict]:
    """(SQLite URL of the configuration's store, what was done): the
    cached store opened, or built first."""
    name = cfg["name"]
    final = cache / f"{name}-{digest(root, cfg)}"
    t0 = time.perf_counter()
    if not (final / "build.json").is_file():
        cache.mkdir(parents=True, exist_ok=True)
        mine = re.compile(re.escape(name) + r"-[0-9a-f]{16}(\.building)?")
        for old in cache.iterdir():
            if mine.fullmatch(old.name):
                shutil.rmtree(old)
        work = final.with_name(final.name + ".building")
        work.mkdir()
        info = build(cfg, work, device, index_mode)
        info["build_s"] = time.perf_counter() - t0
        (work / "build.json").write_text(json.dumps(info, indent=1))
        work.rename(final)
        log(f"[store] built {final.name}: {info['pages']} pages, "
            f"{info['distinct']} distinct blocks, variant pages "
            f"{info['variant_pages']}, build {info['build_s']:.1f} s "
            f"(draw {info['draw_s']:.1f}, register "
            f"{info['register_s']:.1f}, commit {info['commit_s']:.1f})")
        info["built"] = True
    else:
        info = json.loads((final / "build.json").read_text())
        info["built"] = False
        log(f"[store] opened {final.name}: {info['pages']} pages, built "
            f"earlier in {info['build_s']:.1f} s")
    return url_of(final), info


def shape_tree(cfg: Dict) -> Dict:
    """The tree of ``weights.leaf_specs`` with a zero-stride float32
    view in every leaf: what ``lm_tensors`` needs to make the program's
    ``rebuild`` (shapes and served dtypes), with no memory behind it."""
    zero = np.zeros((), np.float32)
    return weights.nested({p: np.broadcast_to(zero, shape)
                           for p, shape, _, _ in weights.leaf_specs(cfg)})
