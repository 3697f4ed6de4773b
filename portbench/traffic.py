"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and draws query ``i`` of a run from ``--seed``.

A query is one ``submit`` of ``rows`` rows of ``tokens`` token ids with
``steps`` tokens to generate a row (1: score the row by its last
position's logits).  Queries come in runs of ``run_length`` for one
variant, the variants in turn; the seed draws the first run's variant,
so every seed makes the same number of switches.  Token ids are uniform
in ``[1, vocab)``.  The check samples ``check_queries`` queries among the
first ``check_within`` (``check.plan``): a span that every window
finishes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *stream])


class Traffic:
    def __init__(self, spec: Dict, variants: Sequence[str], vocab: int,
                 seed: int):
        self.variants, self.vocab, self.seed = list(variants), vocab, seed
        self.rows, self.tokens = int(spec["rows"]), int(spec["tokens"])
        self.steps = int(spec.get("steps", 1))
        self.run_length = int(spec.get("run_length", 1))
        self.first = int(_rng(seed, 0).integers(len(self.variants)))
        self.check_queries = int(spec["check_queries"])
        self.check_within = int(spec["check_within"])

    def variant(self, i: int) -> str:
        run = i // self.run_length
        return self.variants[(self.first + run) % len(self.variants)]

    def _draw(self, rng: np.random.Generator) -> np.ndarray:
        return rng.integers(1, self.vocab, size=(self.rows, self.tokens),
                            dtype=np.int32)

    def query(self, i: int) -> Tuple[str, np.ndarray]:
        """(variant, rows [rows, tokens] int32) of query ``i``."""
        return self.variant(i), self._draw(_rng(self.seed, 2, i))

    def warm(self) -> List[Tuple[str, np.ndarray]]:
        """One query for every variant, the same for every seed, ending on
        the window's first variant (no switch before the first timed
        query): the only shape the mix uses, warmed."""
        rng = _rng(0, 3)
        first = self.variant(0)
        return [(v, self._draw(rng)) for v in self.variants if v != first] \
            + [(first, self._draw(rng))]
