"""Synthetic token batches (own copy of the token generators of
``k8s_tpu/data/synthetic.py``; numpy on the host, no device work in the
input path — the caller moves each batch to its device)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_token_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
) -> Iterator[dict]:
    """One fixed random batch, forever (pure-throughput benching)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab_size, (batch_size, seq_len), np.int32)
    while True:
        yield {"input_ids": ids}


def learnable_token_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
) -> Iterator[dict]:
    """FRESH batches of a deterministic next-token rule: token t is a
    fixed affine function of the row's start token, so a working
    optimizer drives the loss well below its random-init value within
    tens of steps — and a silently broken gradient path does not. The
    data the convergence gates train on (``llama_train
    --data=learnable``)."""
    rng = np.random.default_rng(seed)
    steps = np.arange(seq_len)
    while True:
        start = rng.integers(0, vocab_size, (batch_size, 1))
        yield {
            "input_ids": (
                (start * (steps + 1) * 3 + 7 * steps) % vocab_size
            ).astype(np.int32)
        }
