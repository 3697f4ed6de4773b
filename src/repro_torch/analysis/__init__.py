"""Static contract lints + the runtime page-pool sanitizer.

Two halves (DESIGN.md §7):

* :mod:`repro.analysis.lint` / :mod:`repro.analysis.passes` — stdlib
  AST lints for the protocol contracts (grouped slab writes, host-sync
  hygiene, channel charging, wall-clock bans, API drift).  Run via
  ``scripts/run_lints.py`` / ``make lint``; importing them pulls no
  heavy deps, so they work in a bare container.
* :mod:`repro.analysis.sanitizer` — the opt-in runtime PoolSanitizer
  ("TSan for the page pool"); imported lazily here because it touches
  the jax-backed serving classes.  ``REPRO_SANITIZE=1`` turns it on
  under the whole test suite (see ``tests/conftest.py``).
"""
from .lint import Finding, LintPass, Source, collect_paths, run_lint
from .passes import ALL_PASSES, default_passes

__all__ = [
    "Finding",
    "LintPass",
    "Source",
    "collect_paths",
    "run_lint",
    "ALL_PASSES",
    "default_passes",
    "PoolSanitizer",
    "PoolSanitizerError",
    "PoolEvent",
    "enable",
    "disable",
]

_SANITIZER_NAMES = {"PoolSanitizer", "PoolSanitizerError", "PoolEvent",
                    "enable", "disable"}


def __getattr__(name):
    # lazy: the sanitizer imports the jax-backed pool classes, which the
    # lint driver must not pay for in a bare CI container
    if name in _SANITIZER_NAMES:
        from . import sanitizer
        return getattr(sanitizer, name)
    raise AttributeError(name)
