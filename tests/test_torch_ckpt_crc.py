"""The checkpoint tiers' crc32 (k8s_tpu_torch/ckpt/pipeline.py): the
parallel path (pieces on a thread pool, joined with ``crc32_combine``)
gives ``zlib.crc32`` of the whole payload, the value the JAX package's
tier writes into its manifests."""

import zlib

import numpy as np
import pytest

from k8s_tpu.ckpt.pipeline import crc32_array as jax_crc32_array
from k8s_tpu_torch.ckpt import pipeline


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 1 << 20, (3 << 20) + 13])
def test_crc32_combine_matches_zlib(n):
    rng = np.random.RandomState(n % 97)
    a = rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()
    b = rng.randint(0, 256, size=(n // 3) + 5, dtype=np.uint8).tobytes()
    assert pipeline.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == \
        zlib.crc32(a + b)


@pytest.mark.parametrize(
    "shape,dtype", [(((1 << 21) + 3,), np.uint8), ((333, 1025), np.float32),
                    ((7, 64, 129), np.int8), ((), np.float32)],
    ids=["bytes", "f32", "int8", "scalar"])
def test_parallel_crc32_array_equals_serial(monkeypatch, shape, dtype):
    """The parallel threshold lowered to 64 KiB so small arrays take the
    pool: every cut of the payload into pieces gives the serial value."""
    rng = np.random.RandomState(1)
    arr = np.asarray(rng.randn(*shape) * 100).astype(dtype)
    want = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
    assert pipeline.crc32_array(arr) == want == jax_crc32_array(arr)
    monkeypatch.setattr(pipeline, "CRC_PARALLEL_BYTES", 64 << 10)
    assert pipeline.crc32_array(arr, chunk_bytes=10_000) == want
    assert pipeline.crc32_array(np.asfortranarray(arr)) == \
        zlib.crc32(np.ascontiguousarray(np.asfortranarray(arr)).tobytes()) & 0xFFFFFFFF
