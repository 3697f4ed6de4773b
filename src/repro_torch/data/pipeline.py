"""Deterministic synthetic data pipeline.

Design goals for the 1000+-node story:
  * **Host-sharded determinism**: batch content is a pure function of
    (seed, step, host_slice), so any host can regenerate any shard —
    restart/elastic re-mesh never needs data-state checkpoints, and a
    straggler's microbatch can be dropped or recomputed by a peer.
  * **Model-served tasks** for the paper's evaluation scenarios: a
    synthetic text-classification family (shared "pretrained" embedding +
    per-variant fine-tune deltas) that gives dedup benchmarks real
    accuracy signals on CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                  host_index: int = 0, host_count: int = 1
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite LM batches; ``labels`` = next-token shift of ``tokens``.
    Each (step, host) pair derives its own RNG stream."""
    per_host = batch // host_count
    step = 0
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_index]))
        toks = rng.integers(0, vocab, (per_host, seq + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1


@dataclasses.dataclass
class SyntheticTextTask:
    """A linearly-separable 'review classification' family (paper Sec. 7.1.2).

    A shared 'pretrained' embedding [V, d] plus per-variant class
    directions; variant k's corpus is drawn from its own label planes, so
    fine-tuning mutates a small fraction of embedding rows — exactly the
    paper's multi-version-model sharing structure.
    """
    vocab: int = 2048
    d: int = 64
    num_classes: int = 2
    doc_len: int = 16
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.base_embed = (rng.standard_normal((self.vocab, self.d))
                           * 0.05).astype(np.float32)
        self.class_w = (rng.standard_normal((self.d, self.num_classes))
                        * 0.5).astype(np.float32)
        # class-informative token sets
        self.token_class = rng.integers(0, self.num_classes, self.vocab)

    def variant_embedding(self, variant: int,
                          touched_frac: float = 0.08) -> np.ndarray:
        """Fine-tuned copy: a small random subset of rows gets a delta."""
        rng = np.random.default_rng(self.seed + 1000 + variant)
        emb = self.base_embed.copy()
        n_touch = int(self.vocab * touched_frac)
        rows = rng.choice(self.vocab, n_touch, replace=False)
        emb[rows] += (rng.standard_normal((n_touch, self.d))
                      * 0.02).astype(np.float32)
        return emb

    def sample(self, n: int, *, variant: int = 0,
               seed: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(docs [n, doc_len] int32, labels [n]) — label = majority class
        of the informative tokens in the doc."""
        rng = np.random.default_rng(self.seed + 77 + variant
                                    if seed is None else seed)
        labels = rng.integers(0, self.num_classes, n)
        docs = np.empty((n, self.doc_len), np.int64)
        for i, y in enumerate(labels):
            pool = np.where(self.token_class == y)[0]
            other = rng.integers(0, self.vocab, self.doc_len // 4)
            main = rng.choice(pool, self.doc_len - len(other))
            docs[i] = np.concatenate([main, other])
        return docs.astype(np.int32), labels.astype(np.int32)

    def accuracy(self, embed: np.ndarray, head: np.ndarray,
                 docs: np.ndarray, labels: np.ndarray) -> float:
        """Mean-pooled bag-of-embeddings classifier accuracy."""
        feats = embed[docs].mean(axis=1)                 # [n, d]
        pred = (feats @ head).argmax(axis=1)
        return float((pred == labels).mean())

    def train_head(self, embed: np.ndarray, variant: int = 0,
                   n: int = 512, steps: int = 200,
                   lr: float = 0.5) -> np.ndarray:
        """Logistic-regression head on top of (frozen) embeddings."""
        docs, labels = self.sample(n, variant=variant, seed=self.seed + 5)
        feats = embed[docs].mean(axis=1)
        W = np.zeros((self.d, self.num_classes), np.float32)
        onehot = np.eye(self.num_classes, dtype=np.float32)[labels]
        for _ in range(steps):
            logits = feats @ W
            logits -= logits.max(axis=1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(axis=1, keepdims=True)
            grad = feats.T @ (p - onehot) / len(labels)
            W -= lr * grad
        return W
