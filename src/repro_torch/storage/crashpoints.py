"""Named crash seams + the exhaustive kill-at-every-seam sweep (DESIGN.md §11).

Durability claims are only as good as the set of instants they were
tested at.  Instead of sampling chaos, every multi-step mutation in the
storage layer threads through *named crash points* — one per durable
seam (after each page write, before/after the manifest rename or
COMMIT, mid-prune, mid-journal-truncate).  The registry is populated at
import time, so the sweep can enumerate every seam without executing
anything; :func:`crash_point` is a no-op unless armed.

Arming:

  * ``REPRO_CRASH_POINT=<name>`` (+ ``REPRO_CRASH_MODE=kill|raise``) —
    the subprocess sweep: the armed process SIGKILLs itself the first
    time it reaches the seam, exactly like a power cut mid-syscall.
  * :func:`armed` — an in-process context manager for unit tests;
    ``mode="raise"`` raises :class:`CrashPointReached` instead of
    killing, so a single test can crash an operation and then assert on
    the wreckage.

The harness half of this module (``run_sweep`` / ``python -m
repro.storage.crashpoints --sweep``) runs a scripted store mutation in
a subprocess armed at seam *k*, confirms the process died by SIGKILL,
reopens the store (which replays the intent journal,
``storage/journal.py``), and asserts the recovery invariants: manifest
readable, zero orphan pages, zero temp files, empty journal, and
logits bit-exact against one of the two never-crashed runs (the state
before or after the atomic commit point — nothing else is legal).
Swept **exhaustively over every registered seam**: a registered seam
no scenario reaches fails the sweep.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "CrashPointReached", "register_crash_points", "crash_point",
    "armed", "all_crash_points", "prime_store", "mutate_store",
    "serve_logits", "check_recovered", "run_sweep", "main",
    "ENV_POINT", "ENV_MODE",
]

ENV_POINT = "REPRO_CRASH_POINT"
ENV_MODE = "REPRO_CRASH_MODE"          # "kill" (default) | "raise"

#: name -> human description; populated by register_crash_points() at
#: import time of the module hosting the seam, so enumeration never
#: requires execution
_REGISTRY: Dict[str, str] = {}

#: programmatic arming (tests): (seam name, mode); checked before the
#: environment so an in-process `armed()` block shadows a sweep env
_ARMED: Optional[Tuple[str, str]] = None


class CrashPointReached(RuntimeError):
    """Raised by an armed crash point in ``raise`` mode — the in-process
    stand-in for SIGKILL that unit tests can catch and assert after."""


def register_crash_points(points: Dict[str, str]) -> None:
    """Register named seams (import time).  Re-registration with the
    same description is idempotent; a name collision with a different
    description is a bug in the caller."""
    for name, desc in points.items():
        old = _REGISTRY.get(name)
        if old is not None and old != desc:
            raise ValueError(f"crash point {name!r} already registered "
                             f"with a different description")
        _REGISTRY[name] = desc


def all_crash_points() -> Dict[str, str]:
    """Every registered seam.  Imports the host modules first so the
    registry is complete even if nothing touched storage yet."""
    import repro_torch.core.store          # noqa: F401  (store.save.* seams)
    import repro_torch.storage.journal     # noqa: F401  (recover.* seams)
    import repro_torch.storage.localdir    # noqa: F401
    import repro_torch.storage.sqlite      # noqa: F401
    return dict(_REGISTRY)


def crash_point(name: str) -> None:
    """Mark a durable seam.  No-op unless this exact seam is armed;
    unregistered names are a hard error so the registry stays the
    single exhaustive source of truth for the sweep."""
    if name not in _REGISTRY:
        raise RuntimeError(f"crash_point({name!r}) is not registered; "
                           "add it to the module's register_crash_points()")
    target = _ARMED
    if target is None:
        env = os.environ.get(ENV_POINT)
        if not env:
            return
        target = (env, os.environ.get(ENV_MODE, "kill"))
    if target[0] != name:
        return
    if target[1] == "raise":
        raise CrashPointReached(name)
    # the real thing: no atexit, no finally, no flush — the next
    # instruction never runs, exactly like a power cut
    os.kill(os.getpid(), signal.SIGKILL)


@contextlib.contextmanager
def armed(name: str, mode: str = "raise"):
    """Arm one seam for the duration of a with-block (tests)."""
    global _ARMED
    if name not in all_crash_points():
        raise ValueError(f"unknown crash point {name!r}")
    prev, _ARMED = _ARMED, (name, mode)
    try:
        yield
    finally:
        _ARMED = prev


# ======================================================================
# The scripted store operation the sweep kills at every seam.
#
# Numpy + the core store only (no jax): subprocess startup stays cheap
# enough to afford one process per (seam, backend-kind) pair.
# ======================================================================
def _store_config():
    from ..core import DedupConfig, LSHConfig, StoreConfig
    return StoreConfig(
        dedup=DedupConfig(block_shape=(32, 32),
                          lsh=LSHConfig(num_bands=8, rows_per_band=2,
                                        r=4.0, collision_threshold=6),
                          validate=False),
        blocks_per_page=4)


def _model_tensors(extra: bool = False):
    import numpy as np
    rng = np.random.default_rng(7)
    base = (rng.standard_normal((64, 64)) * 0.05).astype(np.float32)
    out = {"m0": {"w": base.copy()},
           "m1": {"w": (base + np.float32(1e-3)).astype(np.float32)}}
    if extra:
        # dissimilar weights: the repack renames/extends the page set,
        # so the save both writes fresh pages AND prunes orphans
        rng2 = np.random.default_rng(42)
        out["m2"] = {"w": rng2.standard_normal((64, 64))
                     .astype(np.float32)}
    return out


def prime_store(url: str) -> None:
    """Committed baseline: two deduplicating variants saved cleanly."""
    from ..core.store import ModelStore
    store = ModelStore(_store_config())
    for name, tensors in _model_tensors().items():
        store.register(name, tensors)
    store.save(url)


def mutate_store(url: str) -> None:
    """The swept operation: overwrite the primed store with the next
    packing generation — m1's weights revised and a third dissimilar
    model added — so the save writes fresh pages, commits a manifest
    referencing a different page set, AND prunes the primed
    generation's orphans.  Every storage seam fires."""
    import numpy as np

    from ..core.store import ModelStore
    store = ModelStore(_store_config())
    tensors = _model_tensors(extra=True)
    for t in tensors.values():
        # revise every model: no page of the primed generation survives
        # content-addressing, so the prune has real orphans to collect
        t["w"] = (t["w"] * np.float32(1.5)).astype(np.float32)
    for name, t in tensors.items():
        store.register(name, t)
    store.save(url)


def serve_logits(url: str):
    """Deterministic 'serving' probe: a fixed seeded input against every
    model's materialized weights, concatenated.  Bit-exact iff the
    recovered store state is bit-exact."""
    import numpy as np

    from ..core.store import ModelStore
    store = ModelStore.open(url)
    probe = np.random.default_rng(3).standard_normal((8, 64)) \
        .astype(np.float32)
    outs = [probe @ store.materialize(m, "w")
            for m in sorted(store.dedup.models)]
    return np.concatenate([o.reshape(-1) for o in outs])


#: seams strictly AFTER the manifest's atomic commit point: recovery
#: must land on the mutated state (golden B); everything else must
#: roll back to the primed state (golden A)
_POST_COMMIT_SEAMS = frozenset({
    "localdir.commit_manifest.committed",
    "localdir.delete_pages.mid",
    "localdir.journal.rewrite_staged",
    "localdir.journal.rewritten",
    "sqlite.commit_manifest.committed",
    "sqlite.delete_pages.staged",
    "sqlite.journal.rewrite_staged",
    "store.save.manifest_committed",
    "store.save.pruned",
    "recover.gc_journaled",
    "recover.gc_done",
})


def _kinds_for(seam: str) -> Tuple[str, ...]:
    if seam.startswith("localdir."):
        return ("file",)
    if seam.startswith("sqlite."):
        return ("sqlite",)
    return ("file", "sqlite")        # store.save.* / recover.* seams


def _url_for(kind: str, base: str) -> str:
    if kind == "file":
        return f"file://{os.path.join(base, 'store')}"
    return f"sqlite:///{os.path.join(base, 'store.db')}"


def check_recovered(url: str, golden_a, golden_b,
                    expect: Optional[str] = None) -> List[str]:
    """Recovery invariants after a kill; returns human-readable
    violations (empty = clean).  ``expect`` pins which golden the
    recovered store must equal ('a' | 'b' | None = either)."""
    import numpy as np

    from . import open_backend
    backend = open_backend(url)       # replays the journal on open
    problems: List[str] = []
    try:
        if backend.journal_records():
            problems.append("journal not empty after recovery")
        if backend.sweep_temp() != 0:
            problems.append("temp files survived recovery")
        try:
            manifest = backend.load_manifest()
        except FileNotFoundError:
            problems.append("manifest unreadable after recovery")
            return problems
        refs = {p["hash"] for p in manifest["pages"]}
        stored = set(backend.list_pages())
        if stored - refs:
            problems.append(f"{len(stored - refs)} orphan page(s) "
                            "survived recovery")
        if refs - stored:
            problems.append(f"{len(refs - stored)} referenced page(s) "
                            "missing after recovery")
    finally:
        backend.close()
    logits = serve_logits(url)
    is_a = bool(np.array_equal(logits, golden_a))
    is_b = bool(np.array_equal(logits, golden_b))
    if not (is_a or is_b):
        problems.append("recovered logits match neither the pre- nor "
                        "the post-commit never-crashed run")
    elif expect == "a" and not is_a:
        problems.append("recovered to the post-commit state where the "
                        "commit point was never reached")
    elif expect == "b" and not is_b:
        problems.append("recovered to the pre-commit state after the "
                        "commit point had landed")
    return problems


def _golden(kind: str, base: str):
    """(golden_a, golden_b) for one backend kind: logits of the primed
    store and of the cleanly mutated store, never crashed."""
    gdir = os.path.join(base, f"golden-{kind}")
    os.makedirs(gdir, exist_ok=True)
    url = _url_for(kind, gdir)
    prime_store(url)
    golden_a = serve_logits(url)
    mutate_store(url)
    golden_b = serve_logits(url)
    return golden_a, golden_b


def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _sweep_one(seam: str, kind: str, base: str, golden) -> Dict:
    """Kill one subprocess at ``seam`` against a ``kind`` store, then
    recover in-process and check every invariant."""
    workdir = os.path.join(base, f"{seam.replace('.', '_')}-{kind}")
    os.makedirs(workdir, exist_ok=True)
    url = _url_for(kind, workdir)
    prime_store(url)
    cmd = [sys.executable, "-m", "repro_torch.storage.crashpoints",
           "--op", "mutate", "--url", url]
    if seam.startswith("recover."):
        # recovery seams only fire while replaying a dirty journal: the
        # driver first crashes a save in-process (raise mode) to leave
        # one behind, then reopens — and the env-armed kill lands there
        cmd += ["--prime-crash", "store.save.manifest_committed"]
    env = dict(os.environ)
    env[ENV_POINT] = seam
    env[ENV_MODE] = "kill"
    env["PYTHONPATH"] = _src_root() + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    triggered = proc.returncode == -signal.SIGKILL
    result = {"seam": seam, "kind": kind, "triggered": triggered,
              "returncode": proc.returncode, "problems": []}
    if not triggered:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()
        result["problems"] = [
            f"seam never reached (exit {proc.returncode}"
            + (f": {tail[-1]}" if tail else "") + ")"]
        result["ok"] = False
        return result
    expect = "b" if seam in _POST_COMMIT_SEAMS else "a"
    result["problems"] = check_recovered(url, *golden, expect=expect)
    result["ok"] = not result["problems"]
    return result


def run_sweep(seams: Optional[Iterable[str]] = None,
              base_dir: Optional[str] = None,
              verbose=None) -> List[Dict]:
    """The exhaustive sweep: every registered seam (or ``seams``) is
    killed at least once; each kill is recovered and invariant-checked.
    Returns one result dict per (seam, kind) run."""
    registry = all_crash_points()
    chosen = sorted(seams) if seams is not None else sorted(registry)
    unknown = [s for s in chosen if s not in registry]
    if unknown:
        raise ValueError(f"unknown crash point(s): {unknown}")
    results: List[Dict] = []
    with contextlib.ExitStack() as stack:
        if base_dir is None:
            base_dir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="crash-sweep-"))
        golden = {kind: _golden(kind, base_dir)
                  for kind in ("file", "sqlite")}
        for seam in chosen:
            for kind in _kinds_for(seam):
                res = _sweep_one(seam, kind, base_dir, golden[kind])
                results.append(res)
                if verbose:
                    status = "ok" if res["ok"] else \
                        "FAIL: " + "; ".join(res["problems"])
                    verbose(f"[crash-sweep] {seam} ({kind}): {status}")
    return results


def main(argv=None) -> int:
    """CLI: ``--sweep`` (exhaustive), ``--list``, or one ``--op`` (the
    subprocess entry point the sweep arms and kills)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sweep", action="store_true",
                    help="run the exhaustive kill-at-every-seam sweep")
    ap.add_argument("--list", action="store_true",
                    help="list registered crash points and exit")
    ap.add_argument("--op", choices=("prime", "mutate", "logits"),
                    help="run one scripted store operation (the sweep "
                         "subprocess entry point)")
    ap.add_argument("--url", help="storage URL for --op")
    ap.add_argument("--prime-crash", default=None, metavar="SEAM",
                    help="before --op mutate: crash a save at SEAM "
                         "in-process (raise mode) to leave a dirty "
                         "journal, then reopen — reaches the recover.* "
                         "seams")
    args = ap.parse_args(argv)

    if args.list:
        for name, desc in sorted(all_crash_points().items()):
            print(f"{name:<40} {desc}")
        return 0
    if args.sweep:
        results = run_sweep(verbose=print)
        failed = [r for r in results if not r["ok"]]
        swept = {r["seam"] for r in results if r["triggered"]}
        missed = sorted(set(all_crash_points()) - swept)
        print(f"[crash-sweep] {len(results)} kills over "
              f"{len(set(r['seam'] for r in results))} seams: "
              f"{len(failed)} failure(s), {len(missed)} unreached")
        if missed:
            print(f"[crash-sweep] UNREACHED seams: {missed}")
        return 1 if failed or missed else 0
    if args.op:
        if not args.url:
            ap.error("--op requires --url")
        if args.op == "prime":
            prime_store(args.url)
        elif args.op == "mutate":
            if args.prime_crash:
                all_crash_points()      # registry must be loaded first
                try:
                    with armed(args.prime_crash, mode="raise"):
                        mutate_store(args.url)
                except CrashPointReached:
                    pass                # the dirty journal we wanted
                from ..core.store import ModelStore
                ModelStore.open(args.url)    # recovery replays here
            else:
                mutate_store(args.url)
        else:
            print(json.dumps(serve_logits(args.url).tolist()))
        return 0
    ap.error("choose one of --sweep / --list / --op")
    return 2


if __name__ == "__main__":
    # `python -m` executes this file as a SECOND module object named
    # __main__; delegate to the canonical import so the registry (and
    # any armed seam) is the same one the storage modules populate.
    from repro_torch.storage import crashpoints as _canonical
    raise SystemExit(_canonical.main())
