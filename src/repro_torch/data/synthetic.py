"""Deterministic synthetic corpus (the port's own copy of
``repro/data/synthetic.py``: numpy only, the same tokens from the same seed).

No dataset ships with the repository, so this generates a *learnable*
deterministic token stream (orderless-ngram-ish: next token is a hash of a
short context window plus a slowly-varying topic id), so e2e training runs
show a decreasing loss rather than a flat noise floor.

Documents have heavy-tailed lengths; `pack_documents` packs them into
fixed-length rows and reports per-row document counts — the data-dependent
work skew that feeds the L1 work-stealing scheduler's `tails`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _hash(a: np.ndarray) -> np.ndarray:
    a = (a ^ 61) ^ (a >> 16)
    a = (a + (a << 3)) & 0xFFFFFFFF
    a = a ^ (a >> 4)
    a = (a * 0x27D4EB2D) & 0xFFFFFFFF
    return a ^ (a >> 15)


@dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    context: int = 3

    def document(self, doc_id: int, length: int) -> np.ndarray:
        """Deterministic pseudo-document; learnable local structure."""
        rng = np.random.RandomState((self.seed * 1_000_003 + doc_id) % (2**31))
        topic = rng.randint(0, 64)
        toks = np.zeros(length, dtype=np.int64)
        lead = min(self.context, length)
        toks[:lead] = rng.randint(1, self.vocab_size, size=lead)
        base = np.uint32((topic * 2654435761 + self.seed) & 0xFFFFFFFF)
        for i in range(self.context, length):
            ctx = np.uint32(0)
            for j in range(1, self.context + 1):
                ctx = np.uint32(ctx * 1000003) ^ np.uint32(toks[i - j])
            toks[i] = int(_hash(np.uint32(ctx ^ base))) % (self.vocab_size - 1) + 1
        return toks

    def doc_lengths(self, n_docs: int, mean_len: int) -> np.ndarray:
        """Heavy-tailed (lognormal) document lengths >= 8."""
        rng = np.random.RandomState(self.seed + 7)
        ln = rng.lognormal(mean=np.log(mean_len), sigma=0.8, size=n_docs)
        return np.maximum(ln.astype(np.int64), 8)


def pack_documents(corpus: SyntheticCorpus, n_rows: int, seq_len: int):
    """Greedy-pack documents into [n_rows, seq_len] (+1 for labels shift).

    Returns (tokens [n_rows, seq_len], docs_per_row [n_rows]) — the latter is
    the per-row work proxy used as scheduler queue tails in examples.
    """
    tokens = np.zeros((n_rows, seq_len), dtype=np.int64)
    docs_per_row = np.zeros(n_rows, dtype=np.int64)
    doc_id = 0
    lengths = corpus.doc_lengths(n_rows * 8, max(seq_len // 4, 16))
    for r in range(n_rows):
        filled = 0
        while filled < seq_len:
            L = int(lengths[doc_id % len(lengths)])
            take = min(L, seq_len - filled)
            tokens[r, filled : filled + take] = corpus.document(doc_id, take)
            filled += take
            doc_id += 1
            docs_per_row[r] += 1
    return tokens, docs_per_row


def make_batch(cfg, shape, step: int, *, n_rows: int | None = None, seed: int = 0):
    """Materialize one global batch dict for (cfg, shape) as numpy arrays."""
    rows = n_rows if n_rows is not None else shape.global_batch
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed + step)
    seq = shape.seq_len if shape.kind != "decode" else 1
    tokens, _ = pack_documents(corpus, rows, max(seq, 8))
    batch = {"tokens": tokens[:, :seq].astype(np.int32)}
    rng = np.random.RandomState(seed + step + 1)
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(rows, cfg.n_patches, cfg.d_model).astype(np.float32) * 0.02
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(rows, cfg.enc_seq_len, cfg.d_model).astype(np.float32) * 0.02
    return batch
