"""Deterministic synthetic LM streams and packed batches (a copy of
``SyntheticLM`` and of the packing half of ``repro/data/pipeline.py``,
numpy only).

A seeded Zipfian sampler with document boundaries: the same seed and step
give the reference's tokens, token for token, so loss curves are
reproducible across restarts and across the two packages.  The packed
variable-length batches (DESIGN.md §13) draw their corpus from the same
seeded ``SeedSequence`` streams as the reference, so one seed gives one
corpus in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import partition as part

# Sentinel start-position for padding slots: matches the attention PAD
# position (models/attention.PAD), so a padding query's visibility window
# `kv_pos >= doc_start` is empty against every real kv slot.
PAD_START = 2 ** 30
# Label sentinel: slots with label < 0 carry zero loss weight (padding and
# each document's final token, which has no in-document successor).
IGNORE_LABEL = -1


@dataclass
class DataState:
    """Checkpointable pipeline position."""

    seed: int
    step: int


class SyntheticLM:
    """Zipfian token stream with document structure + packing."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, zipf_a: float = 1.2,
                 mean_doc_len: int = 512, bos_id: int = 1):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.state = DataState(seed=seed, step=0)
        self.zipf_a = zipf_a
        self.mean_doc = mean_doc_len
        self.bos = bos_id

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step]))

    def sample_step(self, step: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, labels) of shape [global_batch, seq]."""
        step = self.state.step if step is None else step
        rng = self._rng(step)
        # zipf over the real vocab (capped), packed documents
        toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1))
        toks = np.minimum(toks + 1, self.vocab - 1).astype(np.int32)
        # insert document boundaries (bos) at geometric intervals
        n_docs = max(1, int(self.seq / self.mean_doc))
        for b in range(self.batch):
            cuts = rng.integers(0, self.seq, size=n_docs)
            toks[b, cuts] = self.bos
        tokens, labels = toks[:, :-1], toks[:, 1:]
        return tokens, np.ascontiguousarray(labels)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.sample_step()
            self.state.step += 1

    # --- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState(**d)


# ---------------------------------------------------------------------------
# Packed variable-length batches (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PackedBatch:
    """A packed variable-length batch: documents laid out contiguously in
    fixed-width rows with tail padding only.

    - ``tokens``   [B, S] int32, padding slots hold ``pad_id``
    - ``labels``   [B, S] int32, in-document next token; ``IGNORE_LABEL`` on
      each document's last token and on padding
    - ``seg_ids``  [B, S] int32, global document index per slot, -1 on padding
    - ``doc_start``[B, S] int32, row position where the slot's document
      starts (the attention q_start window), ``PAD_START`` on padding
    - ``spans``    tuple of (row, start, end, doc_idx) per placed document
    """

    tokens: np.ndarray
    labels: np.ndarray
    seg_ids: np.ndarray
    doc_start: np.ndarray
    spans: tuple

    @property
    def n_real_tokens(self) -> int:
        return int((self.seg_ids >= 0).sum())


def sample_doc_lengths(n_docs: int, *, seed: int = 0, dist: str = "zipf",
                       zipf_a: float = 1.6, mean_len: int = 64,
                       sigma: float = 1.0, min_len: int = 2,
                       max_len: Optional[int] = None) -> np.ndarray:
    """Seeded skewed document-length histogram (most docs short, a few
    long) — ``dist`` is "zipf" (heavy tail, rescaled to ``mean_len``) or
    "lognormal" (median ``mean_len``, log-σ ``sigma``)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD0C5]))
    if dist == "zipf":
        raw = rng.zipf(zipf_a, size=n_docs).astype(np.float64)
        raw *= mean_len / raw.mean()
    elif dist == "lognormal":
        raw = rng.lognormal(np.log(max(mean_len, 1)), sigma, size=n_docs)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    lens = np.maximum(np.round(raw).astype(np.int64), min_len)
    if max_len is not None:
        lens = np.minimum(lens, max_len)
    return lens


def sample_corpus(n_docs: int, *, vocab_size: int, seed: int = 0,
                  dist: str = "zipf", zipf_a: float = 1.6,
                  mean_len: int = 64, sigma: float = 1.0,
                  max_len: Optional[int] = None,
                  bos_id: int = 1) -> List[np.ndarray]:
    """Seeded synthetic corpus with a skewed length histogram: one int32
    token array per document, bos-led."""
    lens = sample_doc_lengths(n_docs, seed=seed, dist=dist, zipf_a=zipf_a,
                              mean_len=mean_len, sigma=sigma, max_len=max_len)
    docs = []
    for i, ln in enumerate(lens):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1, i]))
        d = rng.integers(2, vocab_size, size=int(ln)).astype(np.int32)
        d[0] = bos_id
        docs.append(d)
    return docs


def pack_documents(docs: Sequence[np.ndarray], seq_len: int, *,
                   rows: Optional[int] = None, pad_id: int = 0
                   ) -> PackedBatch:
    """Greedy first-fit-decreasing packer: every document lands contiguously
    in exactly one row (no token dropped, duplicated, or split).  ``rows``
    forces the batch row count (must be >= the packed row count; extra rows
    are all-padding)."""
    lengths = [len(d) for d in docs]
    layout = part.pack_lengths(lengths, seq_len)
    n_rows = len(layout) if rows is None else rows
    assert n_rows >= len(layout), \
        f"corpus needs {len(layout)} rows, got rows={rows}"
    tokens = np.full((n_rows, seq_len), pad_id, np.int32)
    labels = np.full((n_rows, seq_len), IGNORE_LABEL, np.int32)
    seg_ids = np.full((n_rows, seq_len), -1, np.int32)
    doc_start = np.full((n_rows, seq_len), PAD_START, np.int32)
    spans = []
    for row, doc_ids in enumerate(layout):
        pos = 0
        for di in doc_ids:
            d = np.asarray(docs[di], np.int32)
            ln = len(d)
            tokens[row, pos:pos + ln] = d
            labels[row, pos:pos + ln - 1] = d[1:]
            seg_ids[row, pos:pos + ln] = di
            doc_start[row, pos:pos + ln] = pos
            spans.append((row, pos, pos + ln, di))
            pos += ln
    return PackedBatch(tokens, labels, seg_ids, doc_start, tuple(spans))


def pad_to_max(docs: Sequence[np.ndarray], seq_len: int, *,
               rows: Optional[int] = None, pad_id: int = 0,
               at_packed_offsets: Optional[PackedBatch] = None
               ) -> PackedBatch:
    """Pad-to-max oracle: one document per row of width ``seq_len``.  With
    ``at_packed_offsets`` each document sits at the same row positions it
    occupies in the packed layout (positions — hence RoPE angles and causal
    windows — are bit-identical between the two layouts, so packed loss and
    grads must match this oracle to fp32 reduction-order tolerance).
    Otherwise documents start at position 0 (the plain SFT baseline)."""
    starts = {}
    if at_packed_offsets is not None:
        starts = {di: s for (_, s, _, di) in at_packed_offsets.spans}
    n_rows = len(docs) if rows is None else rows
    assert n_rows >= len(docs)
    tokens = np.full((n_rows, seq_len), pad_id, np.int32)
    labels = np.full((n_rows, seq_len), IGNORE_LABEL, np.int32)
    seg_ids = np.full((n_rows, seq_len), -1, np.int32)
    doc_start = np.full((n_rows, seq_len), PAD_START, np.int32)
    spans = []
    for row, d in enumerate(docs):
        d = np.asarray(d, np.int32)
        ln = len(d)
        assert ln <= seq_len, f"doc {row} length {ln} > {seq_len}"
        s = starts.get(row, 0)
        tokens[row, s:s + ln] = d
        labels[row, s:s + ln - 1] = d[1:]
        seg_ids[row, s:s + ln] = row
        doc_start[row, s:s + ln] = s
        spans.append((row, s, s + ln, row))
    return PackedBatch(tokens, labels, seg_ids, doc_start, tuple(spans))


def packed_batch_for(doc_lens: Sequence[int], seq_len: int, *, rows: int,
                     vocab_size: int, seed: int = 0,
                     bos_id: int = 1) -> PackedBatch:
    """Deterministic packed batch for a fixed length histogram (the varlen
    budget cell / memledger path): token content seeded per document."""
    docs = []
    for i, ln in enumerate(doc_lens):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1, i]))
        d = rng.integers(2, vocab_size, size=int(ln)).astype(np.int32)
        d[0] = bos_id
        docs.append(d)
    return pack_documents(docs, seq_len, rows=rows)
