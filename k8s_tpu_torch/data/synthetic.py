"""Synthetic image and token batches (own copy of the generators of
``k8s_tpu/data/synthetic.py``, the same numpy ``default_rng`` calls, so
both packages yield identical arrays from one seed; numpy on the host,
no device work in the input path — the caller moves each batch to its
device)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_image_batches(
    batch_size: int,
    image_size: int = 224,
    num_classes: int = 1000,
    seed: int = 0,
) -> Iterator[dict]:
    """One fixed batch of NHWC f32 normal images and int32 labels,
    forever (pure-throughput benching)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, image_size, image_size, 3), np.float32)
    labels = rng.integers(0, num_classes, (batch_size,), np.int32)
    while True:
        yield {"images": images, "labels": labels}


def synthetic_mnist(batch_size: int, seed: int = 0) -> Iterator[dict]:
    """Fresh ``[B, 28, 28, 1]`` f32 normal images and int32 labels of
    10 classes, every batch."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "images": rng.standard_normal((batch_size, 28, 28, 1), np.float32),
            "labels": rng.integers(0, 10, (batch_size,), np.int32),
        }


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
