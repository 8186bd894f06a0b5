"""The decode kernels' split-S grid and merge (k8s_tpu_torch/csrc/
decode_attn.cu and decode_attn_q8.cu), on the CPU.

The kernels run only on the card (tests/test_torch_kernels.py and
chip_smoke.py hold them against their plain versions there). Here:

- ``_decode_split_rows`` reads the cache's shape only, and the grid
  ``(ceil(S / C), Hkv, B)`` it gives covers every cache row < pos[b]
  exactly once and the new token's term once, for every pos in
  [0, S - 1], at S on, below and above a multiple of C;
- an emulation of the kernels' algorithm — per split c of each (b, kv
  head), the rows [c C, min((c + 1) C, pos)) from the cache, the new
  token's term and the append in the split that owns pos only, an empty
  partial (lse = -inf, its output never read) past pos, each partial
  normalised with its natural-log lse, then the splits merged in
  ascending order — matches the plain versions and the JAX package's
  Pallas kernels in interpret mode, bf16 cache and int8 cache, at
  ragged pos on split boundaries (C - 1, C, C + 1) with 0 and S - 1.

Tolerances. Inputs are bf16 values held in f32, so every side computes
exact f32 attention on the same numbers and differs only in summation
order and the exp/log round trip of the merge: a few f32 ulps of
outputs of magnitude < 4, held to 1e-5 (atol and rtol), as the port's
other f32 parity tests. The appended rows (bf16 copies, or int8 rows
and scales quantized by ``quantize_kv_rows``, which is bit-exact with
the JAX quantizer as compiled) are compared bit for bit.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops import attention as jattn
from k8s_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _split_ranges(pos: int, s: int, rows: int):
    """The kernels' split blocks of one (b, kv head), in grid order:
    ``(start, end, owner)`` with cache rows [start, end) read and
    ``owner`` the split that takes the new token and appends row pos;
    None for a split that starts past pos (an empty partial). pos is
    clamped to [0, s - 1] as on the device."""
    pos = min(max(pos, 0), s - 1)
    out = []
    for c in range(-(-s // rows)):
        start = c * rows
        out.append(None if start > pos else
                   (start, min(start + rows, pos), pos < start + rows))
    return out


def test_split_rows_reads_the_shape_only():
    """The split length is a function of (B, Hkv, S): no pos, so the
    grid needs no host sync and stays fixed for a cache."""
    assert list(inspect.signature(tattn._decode_split_rows).parameters) == [
        "b", "hkv", "s"]


@pytest.mark.parametrize("b,hkv,s", [
    (8, 8, 2048), (8, 8, 2047), (8, 8, 2049),        # bf16 serving cache
    (16, 8, 8192), (16, 8, 8191), (16, 8, 8193),     # int8 serving cache
    (1, 8, 100), (1, 1, 1), (2, 2, 64), (64, 8, 512),
])
def test_split_grid_covers_every_row_once(b, hkv, s):
    rows = tattn._decode_split_rows(b, hkv, s)
    assert rows in tattn.DECODE_SPLIT_ROWS
    splits = -(-s // rows)
    # the longest split that still fills DECODE_MIN_BLOCKS, else the shortest
    longer = [r for r in tattn.DECODE_SPLIT_ROWS if r > rows]
    if b * hkv * splits < tattn.DECODE_MIN_BLOCKS:
        assert rows == tattn.DECODE_SPLIT_ROWS[0]
    assert all(b * hkv * -(-s // r) < tattn.DECODE_MIN_BLOCKS for r in longer)
    # every pos at once: rows < pos each read by one split, the new
    # token's term (and the append) in exactly one
    pos = np.arange(s)
    covered = np.zeros(s, dtype=np.int64)
    owners = np.zeros(s, dtype=np.int64)
    next_start = np.zeros(s, dtype=np.int64)
    for c in range(splits):
        start = c * rows
        active = start <= pos
        end = np.minimum(start + rows, pos)
        # ranges follow one another with no gap and no overlap
        assert (next_start[active] == start).all()
        next_start[active] = end[active]
        covered += np.where(active, end - start, 0)
        owners += active & (pos < start + rows)
    assert (covered == pos).all() and (next_start == pos).all()
    assert (owners == 1).all()
    for p in {0, s - 1, min(rows, s - 1), max(rows - 1, 0)}:
        ranges = _split_ranges(p, s, rows)
        assert [c for c, r in enumerate(ranges) if r and r[2]] == [p // rows]


def _emulate(q, k_new, v_new, k_cache, v_cache, pos, scale, rows,
             k_scale=None, v_scale=None):
    """The kernels' algorithm in f32, in place on the caches like the
    kernels: ``out [B, Hq, D]`` f32. With scales, K5's: scores times the
    row's key scale, probabilities times its value scale, the new token
    exact, its row quantized and appended with its scales."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    splits = -(-s // rows)
    part_o = torch.full((b, hkv, splits, g, d), math.nan)
    part_lse = torch.full((b, hkv, splits, g), math.nan)
    reads = torch.zeros((b, hkv, s), dtype=torch.long)
    appends = []
    for bb in range(b):
        for h in range(hkv):
            qf = q[bb, h * g:(h + 1) * g].float() * scale          # [G, D]
            s_new = qf @ k_new[bb, h].float()                       # [G]
            p = min(max(int(pos[bb]), 0), s - 1)
            for c, split in enumerate(_split_ranges(p, s, rows)):
                if split is None:  # empty: its output is never read
                    part_lse[bb, h, c] = -math.inf
                    continue
                start, end, owner = split
                reads[bb, h, start:end] += 1
                kr = k_cache[bb, h, start:end].float()
                vr = v_cache[bb, h, start:end].float()
                sc = qf @ kr.T                                      # [G, n]
                if k_scale is not None:
                    sc = sc * k_scale[bb, h, start:end]
                top = sc.amax(-1) if end > start else torch.full((g,), -math.inf)
                m = torch.maximum(top, s_new) if owner else top
                e = torch.exp(sc - m[:, None])
                l = e.sum(-1)
                if v_scale is not None:
                    e = e * v_scale[bb, h, start:end]
                acc = e @ vr
                if owner:
                    e_new = torch.exp(s_new - m)
                    l = l + e_new
                    acc = acc + e_new[:, None] * v_new[bb, h].float()
                    appends.append((bb, h, p))
                part_o[bb, h, c] = acc / l[:, None]
                part_lse[bb, h, c] = m + torch.log(l)
    # no split reads the row it appends: the append races with nothing
    for bb, h, p in appends:
        assert reads[bb, h, p] == 0
        assert (reads[bb, h, :p] == 1).all() and not reads[bb, h, p:].any()
    assert sorted((bb, h) for bb, h, _ in appends) == [
        (bb, h) for bb in range(b) for h in range(hkv)]
    for bb, h, p in appends:
        if k_scale is None:
            k_cache[bb, h, p] = k_new[bb, h].to(k_cache.dtype)
            v_cache[bb, h, p] = v_new[bb, h].to(v_cache.dtype)
        else:
            for cache, sc, new in ((k_cache, k_scale, k_new),
                                   (v_cache, v_scale, v_new)):
                cache[bb, h, p], sc[bb, h, p] = tattn.quantize_kv_rows(new[bb, h])
    # the merge, splits in ascending order, empty ones skipped
    out = torch.zeros((b, hkv, g, d))
    for bb in range(b):
        for h in range(hkv):
            lse = part_lse[bb, h]                                   # [C, G]
            big = lse.amax(0)
            num, den = torch.zeros(g, d), torch.zeros(g)
            for c in range(splits):
                live = lse[c] != -math.inf
                w = torch.where(live, torch.exp(lse[c] - big), torch.zeros(()))
                num = num + torch.where(live[:, None], w[:, None] * part_o[bb, h, c],
                                        torch.zeros(()))
                den = den + w
            out[bb, h] = num / den[:, None]
    return out.reshape(b, hq, d)


def _bf16_values(seed, *shapes):
    """f32 arrays holding bf16 values (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    return [np.asarray(torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                       .bfloat16().float()) for sh in shapes]


def _boundary_pos(s, rows):
    """Ragged pos on split boundaries, with 0 and S - 1."""
    return np.array([0, rows - 1, rows, rows + 1, s - 1], np.int32)


@pytest.mark.parametrize("rows", [16, 24])
def test_emulated_split_matches_plain(rows):
    """S 64 in splits of 16 (a multiple) and 24 (a ragged last split)."""
    b, hq, hkv, s, d = 5, 8, 2, 64, 32
    q, kn, vn, kc, vc = (torch.from_numpy(a) for a in _bf16_values(
        rows, (b, hq, d), (b, hkv, d), (b, hkv, d), (b, hkv, s, d), (b, hkv, s, d)))
    pos = torch.from_numpy(_boundary_pos(s, rows))
    scale = d ** -0.5
    emu_k, emu_v, ref_k, ref_v = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = _emulate(q, kn, vn, emu_k, emu_v, pos, scale, rows)
    want = tattn.decode_attention_plain(q, kn, vn, ref_k, ref_v, pos, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert torch.equal(emu_k, ref_k) and torch.equal(emu_v, ref_v)


def test_emulated_split_matches_jax_kernel():
    """Against the Pallas kernel in interpret mode (f32, S 64, splits of
    16): output and both caches after the append."""
    b, hq, hkv, s, d, rows = 5, 8, 2, 64, 32, 16
    arrs = _bf16_values(7, (b, hq, d), (b, hkv, d), (b, hkv, d),
                        (b, hkv, s, d), (b, hkv, s, d))
    pos = _boundary_pos(s, rows)
    j_out, j_k, j_v = jattn.decode_attention_update(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(pos), interpret=True)
    q, kn, vn, kc, vc = (torch.from_numpy(a.copy()) for a in arrs)
    got = _emulate(q, kn, vn, kc, vc, torch.from_numpy(pos), d ** -0.5, rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), **F32_TOL)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(j_v))


def _q8_inputs(seed, b, hq, hkv, s, d):
    q, kn, vn, kb, vb = (torch.from_numpy(a) for a in _bf16_values(
        seed, (b, hq, d), (b, hkv, d), (b, hkv, d), (b, hkv, s, d), (b, hkv, s, d)))
    (kc, ks), (vc, vs) = tattn.quantize_kv_rows(kb), tattn.quantize_kv_rows(vb)
    return q, kn, vn, kc, vc, ks, vs


@pytest.mark.parametrize("rows", [16, 24])
def test_emulated_q8_split_matches_plain(rows):
    """K5's split and merge against its plain version at Hq 8, Hkv 2,
    D 128, S 64: out, and the int8 rows and scales it appends bit-equal."""
    b, hq, hkv, s, d = 5, 8, 2, 64, 128
    q, kn, vn, *caches = _q8_inputs(rows + 1, b, hq, hkv, s, d)
    pos = torch.from_numpy(_boundary_pos(s, rows))
    scale = d ** -0.5
    emu = [t.clone() for t in caches]
    ref = [t.clone() for t in caches]
    kc, vc, ks, vs = emu
    got = _emulate(q, kn, vn, kc, vc, pos, scale, rows, ks, vs)
    want = tattn.decode_attention_q8_plain(q, kn, vn, *ref, pos, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    for x, y in zip(emu, ref):
        assert torch.equal(x, y)


def test_emulated_q8_split_matches_jax_kernel():
    """Against ``decode_attention_update_q8(..., interpret=True)`` (f32
    queries and new rows holding bf16 values, S 64, splits of 16): out,
    and the int8 rows and scales after the append bit-equal."""
    b, hq, hkv, s, d, rows = 5, 8, 2, 64, 128, 16
    q, kn, vn, kc, vc, ks, vs = _q8_inputs(9, b, hq, hkv, s, d)
    pos = _boundary_pos(s, rows)
    j = jattn.decode_attention_update_q8(
        *(jnp.asarray(t.numpy()) for t in (q, kn, vn, kc, vc)),
        jnp.asarray(ks.numpy())[:, :, None], jnp.asarray(vs.numpy())[:, :, None],
        jnp.asarray(pos), interpret=True)
    got = _emulate(q, kn, vn, kc, vc, torch.from_numpy(pos), d ** -0.5, rows,
                   ks, vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(j[0]), **F32_TOL)
    for t, want in zip((kc, vc, ks, vs), (j[1], j[2], j[3][:, :, 0], j[4][:, :, 0])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))
