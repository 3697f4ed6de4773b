#!/usr/bin/env python3
"""The readings a cell's check limits are set from, on the card, in one
process: for each seed, a short closed-loop window of the cell's traffic
through the program, the run's sample of its queries (``check.plan``),
and two pairs of readings over that sample against the float32
reference:

* ``program``: the widest gap of a served token and the widest error of
  the kept prefill logits (what a run compares);
* ``control``: the same two numbers of the reference computed in float8
  e4m3 (the next precision below the configuration's bfloat16) put in
  the program's place, which the limits have to fail.

Both are taken over the rows a run judges: those the float32
reference's routing margin does not tie (``check.widest``); the record
also gives the share tied and the widest logit errors over every row.

    python3 portbench/control.py --workload ds7b-2v-score \
        --seeds 101,102,103 [--out chiprun_out/control.json]

The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(root: Path, workload: str, seeds, seconds: float, device=None,
             kernel_mode: str = "auto", index_mode: str = "auto",
             log=print):
    """[{seed, queries, rows, program_gap, program_logit_err,
    control_gap, control_logit_err, ...}] for each seed; the engine is
    built once."""
    import torch
    from portbench import archs, check, harness, store
    from portbench.traffic import Traffic
    device = device or torch.device("cuda", 0)
    bench_dir = root / "portbench"
    bench = harness.read_json(root / "BENCHMARK.json")
    cell = harness.cell_entry(bench, workload)
    cfg = archs.read_config(bench_dir, cell["config"])
    spec = harness.read_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    url, _ = store.ensure(root, cfg, device, index_mode, log,
                          cache=bench_dir / ".cache")
    engine, db = harness.make_engine(cfg, url, device, kernel_mode,
                                     index_mode)
    tie_margin, _ = check.tie_rule(cfg)
    out = []
    try:
        for seed in seeds:
            traffic = Traffic(spec, list(cfg["variants"]), cfg["vocab_size"],
                              seed)
            keep = check.plan(traffic, seed)
            for variant, rows in traffic.warm():
                harness.one_query(engine, variant, rows, traffic.steps)
            queries, _ = harness.window(engine, traffic, seconds, False,
                                        cfg["vocab_size"], log, keep,
                                        last=max(keep))
            done = [q for q in queries if q.served is not None]
            for q in done:
                if q.logits is not None:
                    q.logits = harness.last_position(q.logits,
                                                     q.rows).float().cpu()
            picked = [q for q in done
                      if q.index in keep and q.logits is not None]
            r = check.readings(cfg, traffic, picked, device, ("fp32", "fp8"))
            p, c = r["fp32"], r["fp8"]
            pg, pe, tied = check.widest(p, tie_margin)
            cg, ce, _ = check.widest(c, tie_margin)
            rec = dict(seed=seed, queries=len(queries),
                       failed=len(queries) - len(done),
                       variants=sorted({q.variant for q in picked}),
                       rows=int(p["logit_err"].size),
                       program_gap=pg, program_logit_err=pe,
                       control_gap=cg, control_logit_err=ce,
                       tied_share=tied,
                       all_rows_program_logit_err=float(
                           p["logit_err"].max()),
                       all_rows_control_logit_err=float(
                           c["logit_err"].max()),
                       program_flips=int((p["gap"] > 0).sum()),
                       control_flips=int((c["gap"] > 0).sum()))
            log(json.dumps(rec))
            out.append(rec)
    finally:
        db.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="the window's limit; it ends once the sampled "
                         "queries are served")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    recs = readings(ROOT, args.workload,
                    [int(s) for s in args.seeds.split(",")], args.seconds,
                    log=lambda m: print(m, file=sys.stderr, flush=True))
    summary = dict(workload=args.workload,
                   seconds=time.perf_counter() - T_START, seeds=recs,
                   tied_share_highest=max(r["tied_share"] for r in recs))
    for n in ("gap", "logit_err"):
        summary[f"{n}_lower"] = max(r[f"program_{n}"] for r in recs)
        summary[f"{n}_upper"] = min(r[f"control_{n}"] for r in recs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "seeds"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
