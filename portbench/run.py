#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the CUDA devices of this
machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload ds7b-2v-score --seed 7 \
        --seconds 10 --trace 0

Run it from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (the window under
``torch.profiler``) and a ``breakdown``.  Without a CUDA device, or with
fewer than the cell asks for, it exits 2 and prints no result.  It exits
3 if ``jax``, ``jaxlib``, ``flax`` or the JAX package were loaded.  The
numbers the check compared come last on standard error, each beside its
limit, and last in the result line under ``check``.

The first run of a configuration in a checkout builds its store into
``portbench/.cache`` (see ``store.py``); the caches of the run's
compilers are kept there too, at fixed paths.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
#: top-level module names the process may not hold after the window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE_VARS = (("TRITON_CACHE_DIR", "triton"),
              ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
              ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
              ("CUDA_CACHE_PATH", "nv"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def leaked_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_VARS:
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA device(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    from portbench import harness
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START, log=log)
    leaked = leaked_modules()
    if leaked:
        log(f"portbench: the process loaded {leaked}")
        return 3
    for name, v in result["check"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
