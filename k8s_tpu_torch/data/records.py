"""Fixed-size image records (port of ``k8s_tpu/data/records.py``): the
on-disk contract between the native loader and the training programs,
the same bytes as the JAX package's.

Record layout (static shapes: a batch is one reshape and view-cast away
from a numpy array)::

    [0:8)                int64 little-endian label
    [8:8+H*W*C)          uint8 HWC image

Shard files are ``<prefix>-<s:05d>-of-<n:05d>.rec``, image ``i`` in
shard ``i % n``. ``image_record_batches`` streams them through the
native loader (``native_loader``); ``prefetch.prefetch_to_device`` moves
the batches to the card.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from k8s_tpu_torch.data.native_loader import NativeRecordLoader

_HEADER = 8


def record_bytes(image_size: int, channels: int = 3) -> int:
    return _HEADER + image_size * image_size * channels


def write_image_shards(
    out_dir: str,
    images: np.ndarray,  # [N, H, W, C] uint8
    labels: np.ndarray,  # [N] int
    num_shards: int = 1,
    prefix: str = "train",
) -> List[str]:
    """Write images and labels as sharded fixed-size record files;
    returns their paths."""
    n, h, w, c = images.shape
    if h != w:
        raise ValueError(f"square images only, got {h}x{w}")
    os.makedirs(out_dir, exist_ok=True)
    rb = record_bytes(h, c)
    paths = []
    for s in range(num_shards):
        idx = np.arange(s, n, num_shards)
        buf = np.empty((len(idx), rb), np.uint8)
        buf[:, :_HEADER] = (np.asarray(labels)[idx].astype("<i8")
                            .view(np.uint8).reshape(len(idx), _HEADER))
        buf[:, _HEADER:] = np.asarray(images, np.uint8)[idx].reshape(len(idx), -1)
        path = os.path.join(out_dir, f"{prefix}-{s:05d}-of-{num_shards:05d}.rec")
        buf.tofile(path)
        paths.append(path)
    return paths


def image_record_batches(
    paths: Sequence[str],
    batch_size: int,
    image_size: int,
    channels: int = 3,
    *,
    shuffle_buffer: int = 0,
    seed: int = 0,
    shard_id: int = 0,
    num_shards: int = 1,
    loop: bool = True,
    num_threads: int = 4,
    drop_remainder: Optional[bool] = None,
) -> Iterator[dict]:
    """Stream ``{"images": uint8 [B, H, W, C], "labels": int32 [B]}``
    batches from record shards through the native loader (its zero-copy
    ring; the decode here copies out of the ring, so a yielded batch is
    safe to hold).

    Images stay uint8: the programs normalize on the device (a quarter of
    the host-to-device bytes of f32). ``drop_remainder`` defaults to
    ``loop``: training wants full batches, a single pass (eval) every
    record, the short last batch included."""
    if drop_remainder is None:
        drop_remainder = loop
    loader = NativeRecordLoader(
        paths, record_bytes(image_size, channels), batch_size,
        shuffle_buffer=shuffle_buffer, seed=seed,
        shard_id=shard_id, num_shards=num_shards,
        loop=loop, drop_remainder=drop_remainder, num_threads=num_threads,
    )
    try:
        for raw in loader.iter_zero_copy():
            labels = raw[:, :_HEADER].copy().view("<i8").reshape(-1).astype(np.int32)
            images = raw[:, _HEADER:].reshape(
                raw.shape[0], image_size, image_size, channels).copy()
            yield {"images": images, "labels": labels}
    finally:
        loader.close()
