"""Utterance batching: length sorting, bucketing, padding.

SURVEY.md §2 "Dataset / batching" row. Static shapes are an XLA requirement
(one XLA compile per bucket, reused forever): utterances are sorted by
length, grouped, and padded up to a small set of bucket ceilings derived from
BatchConfig.bucket_boundaries (frames), so the jitted pipeline sees only a
handful of distinct [B, samples] shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mogasr.config import BatchConfig, FrontendConfig


@dataclasses.dataclass
class Batch:
    utt_ids: List[str]
    waves: np.ndarray        # [B, N_bucket] float32, zero padded
    num_samples: np.ndarray  # [B] int32
    words: List[List[str]]   # transcripts (empty lists if unknown)

    @property
    def size(self) -> int:
        return len(self.utt_ids)


def frames_to_samples(frames: int, fcfg: FrontendConfig) -> int:
    return fcfg.frame_length + (frames - 1) * fcfg.frame_shift


def bucket_ceiling(n_samples: int, boundaries_samples: Sequence[int]) -> int:
    for b in boundaries_samples:
        if n_samples <= b:
            return b
    return boundaries_samples[-1]


def make_batches(
    utts: Sequence[Tuple[str, np.ndarray, List[str]]],
    bcfg: BatchConfig,
    fcfg: FrontendConfig,
    drop_overlong: bool = True,
) -> Iterator[Batch]:
    """Group (id, wave, words) triples into padded fixed-shape batches.

    Utterances are length-sorted (minimizes padding waste), grouped into
    batches of at most batch_size *within one bucket*, then padded to the
    bucket ceiling. Batches whose final row count is short are padded with
    zero-length dummy rows so every batch is exactly [batch_size, bucket].
    """
    bounds = [frames_to_samples(f, fcfg) for f in bcfg.bucket_boundaries]
    max_samples = bounds[-1]

    items = []
    for utt_id, wave, words in utts:
        if len(wave) > max_samples:
            if drop_overlong:
                continue
            wave = wave[:max_samples]
        items.append((utt_id, wave, words))
    if bcfg.sort_by_length:
        items.sort(key=lambda it: len(it[1]))

    def emit(group: List, bucket: int) -> Batch:
        B = bcfg.batch_size
        waves = np.zeros((B, bucket), np.float32)
        ns = np.zeros(B, np.int32)
        ids, words_out = [], []
        for i, (utt_id, wave, words) in enumerate(group):
            waves[i, : len(wave)] = wave
            ns[i] = len(wave)
            ids.append(utt_id)
            words_out.append(list(words))
        # dummy padding rows (zero-length) carry empty transcripts so batch
        # consumers can index words[b] for every row
        words_out.extend([[]] * (B - len(group)))
        return Batch(ids, waves, ns, words_out)

    group: List = []
    group_bucket = 0
    for it in items:
        b = bucket_ceiling(len(it[1]), bounds)
        if group and (b != group_bucket or len(group) >= bcfg.batch_size):
            yield emit(group, group_bucket)
            group = []
        group.append(it)
        group_bucket = b
    if group:
        yield emit(group, group_bucket)
