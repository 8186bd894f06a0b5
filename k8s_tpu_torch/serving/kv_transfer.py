"""KV wire format of the serving engine (the port's own copy of
``k8s_tpu/serving/kv_transfer.py``): a prefix snapshot, and later a
prefill→decode handoff or a migrated slot, as one framed body.

Frame layout (all integers little-endian uint32)::

    [manifest_len][manifest JSON utf-8]
    repeat per chunk: [chunk_len][crc32][chunk bytes]

The manifest carries the payload's metadata (for a prefix snapshot
``kind: "prefix"``, ``stage`` and the raw prefix ``tokens``) plus each
leaf's ``shape`` and ``dtype`` NAME in the cache tree's flatten order,
then ``total_bytes``. Leaf payloads are cut into 1 MiB chunks, each with
its own crc32, so a truncated or bit-flipped body fails at the receiver
with ``ValueError``.

For the same ``meta`` and leaves the body is byte for byte the JAX
package's, so a JAX replica and a port replica exchange prefixes. A
bfloat16 leaf travels as its 16-bit words under the dtype name
``"bfloat16"``, as the JAX side writes an ``ml_dtypes`` array; this
module needs no ``ml_dtypes``: :func:`pack_kv` takes torch tensors (any
device) or numpy arrays (an ``ml_dtypes`` bfloat16 one included), and
:func:`unpack_kv` returns CPU torch tensors, bfloat16 ones as
``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

# 1 MiB chunks: framing overhead vanishes, and a mid-transfer kill is
# detected within one crc window
DEFAULT_CHUNK_BYTES = 1 << 20

_U32 = struct.Struct("<I")


def _bytes_of(leaf) -> Tuple[List[int], str, np.ndarray]:
    """``(shape, dtype name, flat uint8 view)`` of one leaf. A torch
    tensor is read through the CPU (a bfloat16 one as its int16 words); a
    numpy array keeps its dtype's name, so an ``ml_dtypes`` bfloat16 array
    says ``"bfloat16"`` as on the JAX side."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(leaf)
        name = a.dtype.name
    return list(a.shape), name, a.reshape(-1).view(np.uint8)


def as_torch(leaf):
    """A leaf as a CPU torch tensor: a torch tensor as is, a numpy array
    (an ``ml_dtypes`` bfloat16 one as ``torch.bfloat16``) without a copy
    unless it is read-only."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if not a.flags.writeable:  # torch tensors are writable
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def pack_kv(meta: Dict, leaves, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> bytes:
    """Serialize ``meta`` (JSON-serializable) and the cache ``leaves``
    (in the cache tree's flatten order) into one framed body. Chunks are
    framed straight from each leaf's contiguous byte view: the one copy
    is the append into the output."""
    specs, flats, total = [], [], 0
    for leaf in leaves:
        shape, name, flat = _bytes_of(leaf)
        specs.append({"shape": shape, "dtype": name})
        flats.append(flat)
        total += flat.size
    manifest = dict(meta)
    manifest["leaves"] = specs
    manifest["total_bytes"] = total
    mbytes = json.dumps(manifest).encode()
    out = bytearray()
    out += _U32.pack(len(mbytes))
    out += mbytes
    wrote = 0
    for flat in flats:
        for off in range(0, flat.size, chunk_bytes):
            chunk = flat[off:off + chunk_bytes]
            out += _U32.pack(chunk.size)
            out += _U32.pack(zlib.crc32(chunk) & 0xFFFFFFFF)
            out += memoryview(chunk)
            wrote += chunk.size
    if wrote == 0:
        # a zero-byte payload still gets one (empty) framed chunk
        out += _U32.pack(0)
        out += _U32.pack(zlib.crc32(b"") & 0xFFFFFFFF)
    return bytes(out)


def _empty_leaf(shape, name: str):
    """A CPU torch tensor of ``shape`` for the dtype ``name``."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"kv transfer: unknown leaf dtype {name!r}")
    return torch.empty(shape, dtype=dtype)


def unpack_kv(body: bytes) -> Tuple[Dict, list]:
    """Parse one framed body back into ``(meta, leaves)``, the leaves as
    CPU torch tensors. Raises ``ValueError`` on any framing, crc or shape
    inconsistency."""
    if len(body) < _U32.size:
        raise ValueError("kv transfer: truncated (no manifest length)")
    (mlen,) = _U32.unpack_from(body, 0)
    off = _U32.size
    if off + mlen > len(body):
        raise ValueError("kv transfer: truncated manifest")
    try:
        manifest = json.loads(body[off:off + mlen])
    except Exception as e:  # noqa: BLE001 - any parse fault is a bad body
        raise ValueError(f"kv transfer: bad manifest: {e}") from e
    off += mlen
    # verify every chunk's crc on views of the body, recording its range
    view = memoryview(body)
    ranges, total_seen = [], 0
    while off < len(body):
        if off + 2 * _U32.size > len(body):
            raise ValueError("kv transfer: truncated chunk header")
        (clen,) = _U32.unpack_from(body, off)
        (crc,) = _U32.unpack_from(body, off + _U32.size)
        off += 2 * _U32.size
        if off + clen > len(body):
            raise ValueError("kv transfer: truncated chunk body")
        if zlib.crc32(view[off:off + clen]) & 0xFFFFFFFF != crc:
            raise ValueError("kv transfer: chunk crc32 mismatch")
        ranges.append((off, clen))
        total_seen += clen
        off += clen
    total = int(manifest.get("total_bytes", -1))
    if total != total_seen:
        raise ValueError(
            f"kv transfer: payload {total_seen} bytes != manifest total {total}")
    specs = manifest.pop("leaves", [])
    leaves = []
    # one copy, body ranges -> each leaf's own buffer (a leaf may span
    # chunk boundaries)
    ri, rpos = 0, 0
    for spec in specs:
        shape = tuple(int(d) for d in spec["shape"])
        leaf = _empty_leaf(shape, spec["dtype"])
        words = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
        flat = words.numpy().reshape(-1).view(np.uint8)
        n, pos = flat.size, 0
        while pos < n:
            if ri >= len(ranges):
                raise ValueError("kv transfer: leaf overruns payload")
            start, clen = ranges[ri]
            take = min(n - pos, clen - rpos)
            flat[pos:pos + take] = np.frombuffer(
                view[start + rpos:start + rpos + take], np.uint8)
            pos += take
            rpos += take
            if rpos == clen:
                ri, rpos = ri + 1, 0
        leaves.append(leaf)
    while ri < len(ranges) and ranges[ri][1] == rpos:
        ri, rpos = ri + 1, 0  # fully consumed or empty trailing frames
    if ri < len(ranges):
        raise ValueError("kv transfer: trailing payload bytes")
    return manifest, leaves
