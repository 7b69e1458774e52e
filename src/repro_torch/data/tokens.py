"""Token data pipeline for the LM substrate: the port's own copy of
``repro.data.tokens`` (numpy only), drawing the same numpy stream, so that
one seed gives bit-identical batches in both packages.

Real deployments plug a tokenized corpus in here; for the repro we ship a
deterministic synthetic corpus (per-task Markov bigram sources so the
multi-task structure is actually present in the token streams: tasks in the
same cluster share a bigram table up to perturbation).

The pipeline is shard-aware: ``TokenPipeline.global_batch`` returns arrays
laid out (global_batch, seq) that the launcher shards along the data axis;
``task_ids`` label which task (data shard group) each row belongs to.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_tasks: int = 1
    seed: int = 0
    tilt: float = 0.3  # strength of the per-task distribution shift
    # make ring-NEIGHBOR tasks similar (circular smoothing of the tilts) —
    # the regime where the paper's graph coupling provably helps
    neighbor_corr: int = 0  # smoothing half-width on the task ring

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # Per-task unigram tilts: shared base + per-task perturbation.
        base = self._rng.standard_normal(self.vocab_size)
        tilt = self.tilt * self._rng.standard_normal((self.num_tasks, self.vocab_size))
        if self.neighbor_corr > 0:
            w = self.neighbor_corr
            sm = np.zeros_like(tilt)
            for off in range(-w, w + 1):
                sm += np.roll(tilt, off, axis=0)
            tilt = sm / (2 * w + 1) * np.sqrt(2 * w + 1)
        logits = base[None] + tilt
        z = np.exp(logits - logits.max(axis=1, keepdims=True))
        self._probs = z / z.sum(axis=1, keepdims=True)

    def global_batch_arrays(self) -> dict[str, np.ndarray]:
        b, s = self.global_batch, self.seq_len
        task_ids = (np.arange(b) * self.num_tasks // max(b, 1)) % self.num_tasks
        tokens = np.stack(
            [
                self._rng.choice(self.vocab_size, size=s + 1, p=self._probs[t])
                for t in task_ids
            ]
        ).astype(np.int32)
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "task_ids": task_ids.astype(np.int32),
        }

    def __iter__(self):
        while True:
            yield self.global_batch_arrays()


def synthetic_lm_batch(
    rng: np.random.Generator, batch: int, seq: int, vocab: int, num_tasks: int = 1
) -> dict[str, np.ndarray]:
    tokens = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    task_ids = (np.arange(batch) * num_tasks // max(batch, 1)) % num_tasks
    return {
        "tokens": tokens[:, :-1].astype(np.int32),
        "labels": tokens[:, 1:].astype(np.int32),
        "task_ids": task_ids.astype(np.int32),
    }
