"""The check that decides ``correct``.

Before the window, ``check_queries`` query indices are drawn from the
seed among the first ``check_within`` of the mix (one of each variant
first, the rest at random); the window keeps the engine's prefill
logits for them.  After the window the weights are drawn again from the
configuration's ``store_seed`` and the float32 reference
(``reference.py``) runs over each sampled query that finished, its
prompt with its served tokens.  Two numbers are compared, over every
row of the sample:

* ``widest_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best logit at that position, held to
  the configuration's ``check.gap_limit``;
* ``widest_logit_err``: the widest absolute difference between the
  program's prefill logits and the reference's at the prompt's last
  position, held to ``check.logit_limit``; it sees an error smaller
  than the margin between the two best tokens, which the gap does not.

A row is *tied* where the float32 reference's routing margin
(``Reference.margins``: the smallest gap between a token's k-th and
(k+1)-th expert score at the compared positions) lies below the
configuration's ``check.tie_margin``: there a program that rounds
otherwise may rightly pick another expert, and its logits then differ by
a whole expert's share.  Tied rows leave both widest numbers; their share
of the sampled rows, ``tied_share``, is held to ``check.tied_limit`` (at
most ``TIED_CAP``), and a sample of tied rows alone fails.  The tie set
comes from the float32 reference alone.  Without ``tie_margin`` (every
configuration that routes nothing) no row is tied and ``tied_limit`` is
0.

Queries that failed (raised, or came back malformed) are held to 0.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, FrozenSet, Sequence, Tuple

import numpy as np
import torch

from portbench import archs, weights
from portbench.reference import Reference, flat_weights

#: device memory the reference may take for its temporaries
BUDGET_BYTES = 16 * 2 ** 30
#: the largest ``tied_limit``: at least half the rows are always judged
TIED_CAP = 0.5


def plan(traffic, seed: int) -> FrozenSet[int]:
    """The indices of the queries the check samples, drawn from ``seed``
    before the window: ``traffic.check_queries`` of the first
    ``traffic.check_within``, one of each variant first."""
    span = traffic.check_within
    rng = np.random.default_rng([seed % 2 ** 64, 4])
    idx = [int(i) for i in rng.permutation(span)]
    picked, seen = [], set()
    for i in idx:
        if traffic.variant(i) not in seen:
            seen.add(traffic.variant(i))
            picked.append(i)
    picked += [i for i in idx if i not in picked]
    return frozenset(picked[:max(traffic.check_queries, len(seen))])


def block_rows(cfg: Dict, tokens: int) -> int:
    """Rows a reference block holds within ``BUDGET_BYTES`` (the
    architecture's ``block_rows``: its largest temporaries a row)."""
    return archs.of(cfg).block_rows(cfg, tokens)


def inputs(traffic, q) -> np.ndarray:
    """The query's prompt and its served tokens but the last: the
    reference's positions are the ones each served token was read at."""
    prompt = traffic.query(q.index)[1]
    return np.concatenate([prompt, q.served[:, :-1]], axis=1)


def gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """[n, steps, V] reference logits, [n, steps] served tokens -> the
    best logit less the served token's, per position."""
    best = logits.max(dim=-1).values
    return best - torch.gather(logits, -1, served[..., None].long())[..., 0]


def row_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, V], [n, V] -> the widest absolute difference of each row."""
    return (a - b).abs().amax(dim=-1)


def readings(cfg: Dict, traffic, picked: Sequence, device,
             precisions=("fp32",)) -> Dict[str, Dict[str, np.ndarray]]:
    """{precision: {"gap": [rows, positions], "logit_err": [rows],
    "margin": [rows]}}.  ``fp32`` judges the program: the gap of its
    served tokens and the error of its kept prefill logits.  ``fp8`` (the
    control) is the reference in float8 put in the program's place: the
    gap, in the float32 reference, of the token it puts first, and the
    error of its logits at the prompt's last position.  ``margin`` is the
    float32 reference's routing margin of each row, the same for every
    precision."""
    out = {p: {"gap": [], "logit_err": [], "margin": []}
           for p in precisions}
    drawn = weights.variant_weights(cfg, device)
    for variant in sorted({q.variant for q in picked}):
        w = flat_weights(drawn[variant])
        mine = [q for q in picked if q.variant == variant]
        toks = torch.as_tensor(np.concatenate([inputs(traffic, q)
                                               for q in mine]),
                               device=device)
        served = torch.as_tensor(np.concatenate([q.served for q in mine]),
                                 device=device)
        steps = served.shape[1]
        block = block_rows(cfg, toks.shape[1])
        ref = Reference(cfg, w)
        logits = ref.last_logits(toks, block, steps)
        margin = ref.margins.cpu().numpy()
        for p in precisions:
            if p == "fp32":
                first = served
                prefill = torch.cat([q.logits for q in mine]).to(device)
            else:
                low = Reference(cfg, w, p).last_logits(toks, block, steps)
                first, prefill = low.argmax(-1), low[:, 0]
            out[p]["gap"].append(gaps(logits, first).cpu().numpy())
            out[p]["logit_err"].append(
                row_err(prefill.float(), logits[:, 0]).cpu().numpy())
            out[p]["margin"].append(margin)
        del w, ref, logits
    del drawn
    return {p: {k: np.concatenate(v) for k, v in r.items()}
            for p, r in out.items()}


def tie_rule(cfg: Dict) -> Tuple[float, float]:
    """(tie_margin, tied_limit) of the configuration's ``check``; both 0
    where it routes nothing."""
    c = cfg["check"]
    margin = float(c.get("tie_margin", 0.0))
    limit = float(c.get("tied_limit", 0.0))
    if not 0.0 <= limit <= TIED_CAP or margin < 0.0:
        raise ValueError(f"{cfg['name']}: tied_limit {limit} outside [0, "
                         f"{TIED_CAP}] or tie_margin {margin} below 0")
    return margin, limit


def widest(r: Dict[str, np.ndarray], tie_margin: float
           ) -> Tuple[float, float, float]:
    """(widest gap, widest logit error, tied share) of one precision's
    readings over the rows that are not tied; the widest numbers are
    ``inf`` where every row is."""
    tied = r["margin"] < tie_margin
    share = float(tied.mean()) if tied.size else 0.0
    if tied.all():
        return float("inf"), float("inf"), share
    judged = ~tied
    return (float(r["gap"][judged].max()),
            float(r["logit_err"][judged].max()), share)


def judge(cfg: Dict, traffic, done: Sequence, failed: int,
          planned: FrozenSet[int], device, log: Callable[[str], None]
          ) -> Dict:
    t0 = time.perf_counter()
    picked = [q for q in done if q.index in planned and q.logits is not None]
    gap_limit = float(cfg["check"]["gap_limit"])
    logit_limit = float(cfg["check"]["logit_limit"])
    tie_margin, tied_limit = tie_rule(cfg)
    if picked:
        r = readings(cfg, traffic, picked, device)["fp32"]
        gap, err, tied = widest(r, tie_margin)
    else:
        r, gap, err, tied = ({"gap": np.zeros(0)}, float("inf"),
                             float("inf"), 0.0)
    log(f"[check] {len(picked)} of {len(planned)} sampled queries "
        f"finished, {r['gap'].size} served tokens of "
        f"{sorted({q.variant for q in picked})} against the float32 "
        f"reference in {time.perf_counter() - t0:.1f} s; "
        f"{tied:.4f} of the rows tied")
    return {"correct": bool(gap <= gap_limit and err <= logit_limit
                            and tied <= tied_limit),
            "numbers": {"widest_gap": {"value": gap, "limit": gap_limit},
                        "widest_logit_err": {"value": err,
                                             "limit": logit_limit},
                        "tied_share": {"value": tied, "limit": tied_limit},
                        "failed": {"value": failed, "limit": 0}}}
