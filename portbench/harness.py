"""One run of one cell: set-up, the measured window, the check.

``run_cell`` finds the cell's files by name (the configuration's
architecture module under ``archs/`` too), opens (or builds) the
configuration's store, builds the engine the way a user serves LM
variants from the database (``DedupDB.open(url).serve_lm(...,
compute_backend="device", kernel_mode="auto", scheduler="fifo")``, the
slab large enough for every page of every variant), warms the cell's
shapes, and then runs a closed loop for ``seconds``: one client issues
queries back to back, each ``engine.submit(variant, rows, steps)`` then
``engine.run()``; a query's latency runs from ``submit`` until its tokens
are on the host.  The queries the check samples are drawn from the seed
before the window, and the window keeps the prefill logits the engine
computed for them.  After the window it frees the program, draws the
weights again from the configuration's seed, runs the float32 reference
over the sampled queries that finished, and judges the served tokens and
the kept logits against it (``check.py``).

With ``trace`` the window runs under ``torch.profiler``, the engine's
model switch and compute calls are timed (each ending in a device
synchronize), and the host's phase is marked so that the device's idle
time can be told by what the host was doing (``trace.py``).  The
program's wall-clock tracer (``repro_torch.obs.wall.WallTracer``, with no
profiler ranges of its own) is installed from the engine's build on, and
its per-name span totals are read at the build, at the window's start and
at its end: ``Run.setup_spans`` and ``Run.spans`` are the differences.
Every metric is a reader in ``metrics/<name>.py``; a reader may name the
program's counters it reads in ``COUNTERS`` (``"module:attr"``: a
dictionary of numbers, a number or a 0-d tensor), which are read at the
window's two ends, outside it, into ``Run.counters``.  An untraced run
installs no tracer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import numbers
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import archs, check, load_module, store, weights
from portbench.traffic import Traffic



@dataclasses.dataclass
class Query:
    index: int
    variant: str
    rows: int
    tokens: int
    start: float                    # perf_counter at submit
    end: float                      # perf_counter with tokens on the host
    served: Optional[np.ndarray]    # [rows, steps] int32, None if it failed
    switched: bool                  # the engine changed variant for it
    logits: Optional[torch.Tensor] = None   # [rows, V] prefill, if sampled


@dataclasses.dataclass
class Run:
    """What a metric reader sees."""
    cell: Dict
    cfg: Dict
    traffic: Dict
    queries: List[Query]
    window_s: float
    setup_s: float
    peaks: Dict
    switch_s: List[float] = dataclasses.field(default_factory=list)
    compute_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[object] = None  # trace.Summary with --trace 1
    #: the program's spans, {name: (count, seconds)}, over the window and
    #: from the engine's build to the window (traced runs)
    spans: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    setup_spans: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    #: {"module:attr": the window's difference} of the readers' COUNTERS
    #: that resolved
    counters: Dict[str, object] = dataclasses.field(default_factory=dict)

    def done(self) -> List[Query]:
        return [q for q in self.queries if q.served is not None]


# -------------------------------------------------------------- finding --
def read_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def cell_entry(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


# ------------------------------------------------------------- program --
def model_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration file (its
    architecture's ``program_config``), its layers' windows held against
    the configuration's."""
    from repro_torch.models.transformer import build_groups
    mc = archs.of(cfg).program_config(cfg)
    got = [w for g in build_groups(mc) for w in g.windows]
    if got != weights.windows(cfg):
        raise ValueError(f"{cfg['name']}: the program's windows {got}, the "
                         f"configuration's {weights.windows(cfg)}")
    return mc


def make_engine(cfg: Dict, url: str, device, kernel_mode: str,
                index_mode: str):
    """(engine, database): the store opened live and served as a user
    serves its LM variants, the slab holding every page of every
    variant."""
    from repro_torch.convert import lm_tensors
    from repro_torch.db import DedupDB
    from repro_torch.models import build
    mc = model_config(cfg)
    rebuild = lm_tensors(store.shape_tree(cfg), dtype=cfg["torch_dtype"],
                         per_layer=True).rebuild
    db = DedupDB.open(url, index_mode=index_mode, device=device)
    variants = list(cfg["variants"])
    engine = db.serve_lm({v: build(mc) for v in variants},
                         {v: {"rebuild": rebuild} for v in variants},
                         capacity_pages=db.store.num_pages(),
                         scheduler="fifo", compute_backend="device",
                         kernel_mode=kernel_mode, device=device)
    return engine, db


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ------------------------------------------------- spans and counters --
def span_delta(a: Dict, b: Dict) -> Dict[str, Tuple[int, float]]:
    """{name: (count, seconds)} of the spans finished between two
    snapshots of ``WallTracer.totals``."""
    out = {}
    for name, (n, sec) in b.items():
        n0, s0 = a.get(name, (0, 0.0))
        if n > n0:
            out[name] = (n - n0, sec - s0)
    return out


def read_counter(name: str):
    """A snapshot of ``"module:attr"``: {key: float} of a dictionary of
    numbers, or a float of a number or a 0-d tensor; ``None`` where the
    name does not resolve or holds something else."""
    mod, _, attr = name.partition(":")
    try:
        obj = importlib.import_module(mod)
        for part in attr.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError, ValueError):
        return None

    def number(v):
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            return float(v.item())
        if isinstance(v, numbers.Real) and not isinstance(v, bool):
            return float(v)
        return None
    if isinstance(obj, dict):
        vals = {k: number(v) for k, v in obj.items()}
        return None if None in vals.values() else vals
    return number(obj)


def counter_delta(a, b):
    """The difference of two ``read_counter`` snapshots of one name."""
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: v - a.get(k, 0.0) for k, v in b.items()}
    if isinstance(a, float) and isinstance(b, float):
        return b - a
    return None


def read_counters(names) -> Dict[str, object]:
    return {n: read_counter(n) for n in names}


@contextlib.contextmanager
def program_tracer(on: bool):
    """The program's ``WallTracer`` installed for the body (``None``, and
    the program's tracer left as it is, where ``on`` is false); the
    previous tracer comes back however the body ends."""
    if not on:
        yield None
        return
    from repro_torch.obs import use_tracer
    from repro_torch.obs.wall import WallTracer
    with use_tracer(WallTracer(profile=False)) as tracer:
        yield tracer


def totals(tracer) -> Dict[str, Tuple[int, float]]:
    return dict(tracer.totals) if tracer is not None else {}


# -------------------------------------------------------------- window --
class _Timed:
    """The engine's switch and compute calls, timed on the host clock
    and ending in a device synchronize, each inside a profiler range."""

    def __init__(self, engine, run: Run, sync: Callable[[], None]):
        self.engine, self.run, self.sync = engine, run, sync
        self.load, self.compute = engine._load_model, engine._compute
        engine._load_model, engine._compute = self._load, self._compute

    def _load(self, model, grouped=False):
        switching = self.engine._resident_model != model
        with torch.profiler.record_function("phase:switch"):
            t0 = time.perf_counter()
            out = self.load(model, grouped)
            self.sync()
            if switching:
                self.run.switch_s.append(time.perf_counter() - t0)
        return out

    def _compute(self, model, prompts, steps):
        with torch.profiler.record_function("phase:compute"):
            t0 = time.perf_counter()
            out = self.compute(model, prompts, steps)
            self.run.compute_s.append(time.perf_counter() - t0)
        return out


def one_query(engine, variant: str, rows: np.ndarray, steps: int):
    engine.submit(variant, rows, steps=steps)
    engine.run()
    return engine.last_tokens


def last_position(logits: torch.Tensor, rows: int) -> torch.Tensor:
    """The engine's prefill logits as [rows, V] (the prompt's last
    position); NaN where the engine's rows are not the query's, so that
    the check fails them."""
    if logits.shape[0] != rows:
        return torch.full((rows, logits.shape[-1]), float("nan"))
    return logits.reshape(rows, -1, logits.shape[-1])[:, -1]


def _phase(trace: bool, name: str):
    return torch.profiler.record_function(f"phase:{name}") if trace \
        else contextlib.nullcontext()


def window(engine, traffic: Traffic, seconds: float, trace: bool,
           vocab: int, log, keep=frozenset(),
           last: Optional[int] = None) -> tuple:
    """The closed loop: (queries, window seconds), ending at ``seconds``
    or after query ``last``.  Queries whose index is in ``keep`` hold the
    engine's prefill logits (a reference to the tensor the engine made,
    no copy and no sync in the window)."""
    queries: List[Query] = []
    t_begin = time.perf_counter()
    deadline = t_begin + seconds
    i = 0
    with _phase(trace, "window"):
        while time.perf_counter() < deadline and (last is None
                                                   or i <= last):
            with _phase(trace, "client"):
                variant, rows = traffic.query(i)
            switched = engine._resident_model != variant
            t0 = time.perf_counter()
            try:
                with _phase(trace, "engine"):
                    served = one_query(engine, variant, rows, traffic.steps)
            except Exception as e:          # noqa: BLE001 - counted, run ends
                log(f"[window] query {i} ({variant}) raised {e!r}")
                queries.append(Query(i, variant, *rows.shape, t0,
                                     time.perf_counter(), None, switched))
                break
            t1 = time.perf_counter()
            ok = served is not None \
                and served.shape == (rows.shape[0], traffic.steps) \
                and bool(((served >= 0) & (served < vocab)).all())
            queries.append(Query(i, variant, *rows.shape, t0, t1,
                                 np.array(served) if ok else None, switched,
                                 engine.last_logits if i in keep else None))
            i += 1
    return queries, time.perf_counter() - t_begin


# ----------------------------------------------------------------- run --
def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device=None,
             kernel_mode: str = "auto", index_mode: str = "auto",
             log: Callable[[str], None] = print) -> Dict:
    """One run of ``workload``; returns the result line's object (its
    ``check`` entry last).  ``device`` defaults to the first CUDA
    device; the CPU tests pass ``torch.device("cpu")`` with the
    program's ``torch`` modes."""
    device = device or torch.device("cuda", 0)
    cuda = device.type == "cuda"
    bench = read_json(root / "BENCHMARK.json")
    bench_dir = root / "portbench"
    cell = cell_entry(bench, workload)
    cfg = archs.read_config(bench_dir, cell["config"])
    spec = read_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    url, built = store.ensure(root, cfg, device, index_mode, log,
                              cache=bench_dir / ".cache")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kind = "end_to_end" if not trace else "per_layer"
    readers = {m["name"]: (m, load_module(bench_dir, "metrics", m["name"]))
               for m in metrics_of(bench, workload, kind)}
    counted = sorted({n for _, mod in readers.values()
                      for n in getattr(mod, "COUNTERS", ())})
    with program_tracer(trace) as tracer:
        at_build = totals(tracer)
        engine, db = make_engine(cfg, url, device, kernel_mode, index_mode)
        traffic = Traffic(spec, list(cfg["variants"]), cfg["vocab_size"],
                          seed)
        keep = check.plan(traffic, seed)
        t0, c0 = time.perf_counter(), time.process_time()
        warm = traffic.warm()
        for variant, rows in warm:
            one_query(engine, variant, rows, traffic.steps)
        sync()
        log(f"[setup] {len(warm)} warm-up queries "
            f"{time.perf_counter() - t0:.2f} s ({time.process_time() - c0:.2f}"
            f" s of host CPU), the first switches from the store included; "
            f"{time.perf_counter() - t_start:.2f} s since the process began")
        run = Run(cell, cfg, spec, [], 0.0, time.perf_counter() - t_start,
                  read_json(bench_dir / "peaks.json"))
        at_start, counts_start = totals(tracer), read_counters(counted)

        prof = contextlib.nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile
            _Timed(engine, run, sync)
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else []))
        with prof:
            run.queries, run.window_s = window(engine, traffic, seconds,
                                               trace, cfg["vocab_size"], log,
                                               keep)
            sync()
            at_end, counts_end = totals(tracer), read_counters(counted)
    run.setup_spans = span_delta(at_build, at_start)
    run.spans = span_delta(at_start, at_end)
    for n in counted:
        delta = counter_delta(counts_start[n], counts_end[n])
        if delta is not None:
            run.counters[n] = delta
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        from portbench import trace as trace_mod
        run.trace = trace_mod.summarize(prof)
    del prof

    attempted = len(run.queries)
    failed = sum(q.served is None for q in run.queries)
    metrics = {}
    for name, (m, reader) in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs; the sampled
    # queries' logits are outputs, kept on the host
    for q in run.queries:
        if q.logits is not None:
            q.logits = last_position(q.logits, q.rows).float().cpu()
    del engine
    db.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check.judge(cfg, traffic, run.done(), failed, keep, device,
                          log)

    result = {
        "correct": verdict["correct"] and failed == 0 and attempted > 0,
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
            "power_limit": power_limit() if cuda else "none"},
    }
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["store"] = {"built": built["built"], "build_s": built["build_s"]}
    result["check"] = verdict["numbers"]
    return result
