"""Deterministic synthetic LM stream (a copy of ``SyntheticLM`` from
``repro/data/pipeline.py``, numpy only).

A seeded Zipfian sampler with document boundaries: the same seed and step
give the reference's tokens, token for token, so loss curves are
reproducible across restarts and across the two packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


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
