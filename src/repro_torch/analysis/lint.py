"""Repo-specific static analysis over stdlib :mod:`ast`.

The serving/storage layers stay correct only because of protocol
contracts the type system cannot see — grouped slab writes, virtual
clock channel charging, remap-generation freshness (DESIGN.md §7).
This module is the tiny framework the contract lints plug into:

* :class:`Finding` — one violation, printable as ``path:line:col``.
* :class:`Source` — a parsed file plus its ``# repro: allow-<token>``
  pragma table.  A pragma on the flagged line *or the line directly
  above it* suppresses a finding whose pass declares that token.
* :class:`LintPass` — base class; subclasses implement
  :meth:`LintPass.run` and emit findings via :meth:`LintPass.finding`
  (which consults the pragma table, so passes never re-implement
  suppression).
* :func:`run_lint` — collect ``.py`` files, parse once, run every pass.

No third-party dependencies: the passes must run in a bare CI
container before anything is installed.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence

__all__ = [
    "Finding",
    "Source",
    "LintPass",
    "collect_paths",
    "run_lint",
]

# ``# repro: allow-host`` / ``# repro: allow-host, allow-uncharged``;
# free-form rationale after the tokens is encouraged and ignored
_PRAGMA_RE = re.compile(r"#\s*repro:\s*(.*)$")
_TOKEN_RE = re.compile(r"allow-[a-z][a-z0-9-]*")


def parse_pragmas(text: str) -> Dict[int, FrozenSet[str]]:
    """1-based line -> set of ``allow-*`` tokens declared on that line.

    Scope rules live in :meth:`Source.allowed`: a comment-only pragma
    line also covers the line below it; a trailing pragma covers only
    its own line, so it cannot bleed onto the next statement.
    """
    out: Dict[int, FrozenSet[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        toks = frozenset(_TOKEN_RE.findall(m.group(1)))
        if toks:
            out[i] = toks
    return out


def comment_only_lines(text: str) -> FrozenSet[int]:
    """1-based numbers of lines that are nothing but a comment."""
    return frozenset(i for i, line in enumerate(text.splitlines(), start=1)
                     if line.lstrip().startswith("#"))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation at ``path:line:col`` from pass ``name``."""
    path: str
    line: int
    col: int
    name: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.name}] {self.message}"


class Source:
    """A parsed source file: text, AST, and the pragma table."""

    def __init__(self, path: str, text: str):
        # normalized separators so passes can match path suffixes portably
        self.path = str(path).replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        self.pragmas = parse_pragmas(text)
        self._comment_only = comment_only_lines(text)

    @classmethod
    def load(cls, path) -> "Source":
        return cls(str(path), Path(path).read_text())

    def allowed(self, line: int, token: str) -> bool:
        """True if ``token`` is granted on ``line``, or on a
        comment-only pragma line directly above it (a trailing pragma
        on the previous statement does NOT bleed downward)."""
        if token in self.pragmas.get(line, ()):
            return True
        return line - 1 in self._comment_only \
            and token in self.pragmas.get(line - 1, ())

    def endswith(self, *suffixes: str) -> bool:
        return self.path.endswith(suffixes)


class LintPass:
    """Base class for one contract check.

    Subclasses set ``name`` (finding tag), ``pragma`` (the
    ``allow-*`` token that suppresses it; ``None`` = unsuppressable)
    and ``description``, then implement :meth:`run`.
    """

    name: str = "lint"
    pragma: Optional[str] = None
    description: str = ""

    def run(self, src: Source) -> List[Finding]:
        raise NotImplementedError

    def finding(self, src: Source, node: ast.AST, message: str
                ) -> Optional[Finding]:
        """Build a finding unless a pragma on/above the line allows it."""
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        if self.pragma is not None and src.allowed(line, self.pragma):
            return None
        return Finding(src.path, line, col, self.name, message)


def collect_paths(paths: Sequence) -> List[Path]:
    """Expand files/directories into a sorted list of ``.py`` files,
    skipping hidden directories and caches."""
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                parts = f.relative_to(p).parts
                if any(s.startswith(".") or s == "__pycache__"
                       for s in parts):
                    continue
                out.append(f)
        elif p.suffix == ".py":
            out.append(p)
    return out


def run_lint(paths: Sequence, passes: Optional[Iterable[LintPass]] = None,
             ) -> List[Finding]:
    """Run ``passes`` (default: every registered pass) over ``paths``.

    Returns findings sorted by (path, line, col).  Files that fail to
    parse produce a single ``syntax`` finding instead of crashing the
    whole run.
    """
    if passes is None:
        from .passes import default_passes
        passes = default_passes()
    passes = list(passes)
    findings: List[Finding] = []
    for path in collect_paths(paths):
        try:
            src = Source.load(path)
        except SyntaxError as e:
            findings.append(Finding(str(path).replace(os.sep, "/"),
                                    e.lineno or 1, e.offset or 0,
                                    "syntax", f"failed to parse: {e.msg}"))
            continue
        for p in passes:
            findings.extend(f for f in p.run(src) if f is not None)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.name))
    return findings
