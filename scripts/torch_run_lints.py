#!/usr/bin/env python
"""Run the PyTorch / CUDA port's contract lints (and ruff, when
installed) over src/repro_torch: the port's counterpart of
scripts/run_lints.py, with every pass keyed to ``repro_torch/...``
(``repro_torch.analysis.default_passes()``: the torch host syncs in the
serving hot paths and the in-place slab writes included).

Exit status is non-zero on any finding.  The custom passes are
stdlib-only (`repro_torch.analysis.lint` imports no heavy deps), so this
runs in a bare container; ruff is an optional extra — absent, it is
skipped with a notice rather than failing the build.
"""
import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.lint import run_lint          # noqa: E402
from repro_torch.analysis.passes import default_passes  # noqa: E402

RUFF_PIN = "ruff==0.12.5"                         # match pyproject [dev]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--no-ruff", action="store_true",
                    help="run only the custom contract passes")
    ap.add_argument("--list-passes", action="store_true",
                    help="list registered passes and exit")
    args = ap.parse_args(argv)

    passes = default_passes()
    if args.list_passes:
        for p in passes:
            print(f"{p.name:<16} {p.description}")
        return 0

    paths = [str(ROOT / p) if not Path(p).is_absolute()
             and not Path(p).exists() else p for p in args.paths]

    findings = run_lint(paths, passes)
    for f in findings:
        print(f)
    rc = 1 if findings else 0
    print(f"contract lints: {len(findings)} finding(s) over "
          f"{len(paths)} path(s) [{', '.join(p.name for p in passes)}]")

    if not args.no_ruff:
        ruff = shutil.which("ruff")
        if ruff:
            proc = subprocess.run([ruff, "check", *paths], cwd=ROOT)
            fmt = subprocess.run([ruff, "format", "--check", *paths],
                                 cwd=ROOT)
            if proc.returncode or fmt.returncode:
                rc = 1
        else:
            print(f"ruff not installed; skipping (pip install {RUFF_PIN})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
