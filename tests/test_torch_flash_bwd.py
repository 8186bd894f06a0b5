"""The flash backward kernels' tiling (k8s_tpu_torch/csrc/flash_bwd.cu), on
the CPU.

The kernels themselves run only on the card (tests/test_torch_kernels.py
and chip_smoke.py hold them against their plain version there). Here:

- K2's grid (q head, batch, 128-row query blocks last-first) covers every
  (b, q head, query row) exactly once, and K3's (128-key blocks, kv head,
  batch; the key blocks of one (batch, kv head) adjacent, the first keys
  first) every (b, kv head, key) exactly once;
- an emulation of each kernel's tile algorithm — per block two consumer
  warpgroups of 64 rows; K2 streams 64-key tiles and stops at the
  warpgroup's diagonal, K3 walks the G query heads of its kv head and,
  for each, the 64-row query tiles from the block's diagonal on (a
  warpgroup skips the tiles above its keys); P in base 2 with
  ``scale * log2(e)`` and ``lse * log2(e)`` folded in; the mask applied
  only to a tile that crosses the diagonal or a sequence end, rows past
  the end read as zeros (TMA's fill); P and dS rounded to bf16 before
  the products that take them from registers — matches
  ``flash_bwd_plain`` and the JAX package's ``_flash_backward`` run in
  interpret mode, at causal S 1, 65, 129, 200 and non-causal Sq 100 over
  Sk 237, with 4 and 3 query heads per kv head;
- the lse/D rows the kernels read are padded to a TMA-legal stride.

Tolerances. Inputs are bf16 values held in f32, so both references are
exact f32 math (they agree to ~5e-6 absolute); the emulation differs from
them by rounding P and dS to bf16 (2^-9 relative each) before dQ = dS K,
dK = dS^T Q and dV = P^T dO. Rows are compared by ||x - ref|| / ||ref||
with ||ref|| raised to ROW_FLOOR of the tensor's largest row norm (rows
that vanish in exact math, e.g. causal dq row 0, where dS = P (dP - D)
cancels). The worst row of these shapes reads 2.9e-3 to 4.6e-3; the
limit is 6e-3 (the card's is 1e-2, which also covers the bf16 outputs).
At causal S 1 dq and dk vanish entirely (one visible key: P = 1, dS = 0),
so their floor is taken from what dq and dk would be without that
cancellation, scale * dP * K and scale * dP * Q: the limit then says that
they are zero to 6e-6 of that scale.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops import attention as jattn
from k8s_tpu_torch.ops import attention as tattn

LOG2E = 1.4426950408889634
BLOCK = 128  # rows a block owns: queries (K2), keys (K3); 64 per warpgroup
TILE = 64    # rows per streamed tile: keys (K2), queries (K3)
ROW_TOL = 6e-3
ROW_FLOOR = 1e-3


def _dq_grid(b, sq, hq):
    """K2's blocks in launch order: blockIdx (x, y, z) = (q head, batch,
    query block counted from the last) -> (b, h, q0)."""
    nz = -(-sq // BLOCK)
    return [(y, x, (nz - 1 - z) * BLOCK)
            for z in range(nz) for y in range(b) for x in range(hq)]


def _dkv_grid(b, sk, hkv):
    """K3's blocks in launch order: blockIdx (x, y, z) = (key block, kv
    head, batch) -> (b, hk, k0)."""
    nx = -(-sk // BLOCK)
    return [(z, y, x * BLOCK)
            for z in range(b) for y in range(hkv) for x in range(nx)]


def _rows(x, start, n):
    """A TMA box: rows start .. start + n of x, zeros past its end."""
    tile = torch.zeros((n,) + tuple(x.shape[1:]))
    part = x[start:start + n]
    tile[:len(part)] = part
    return tile


def _bf16(x):
    return x.bfloat16().float()


def _seg_rows(seg, bb, start, n):
    """Segment ids of rows start .. start + n of batch bb, 0 past the end
    (masked there anyway)."""
    return _rows(seg[bb, :, None].float(), start, n)[:, 0]


def _emulate_dq(q, k, v, do, lse, dd, causal, scale, seg=None):
    """K2's algorithm on f32 copies of bf16 inputs: dq [B, Sq, Hq, D].
    With segment ids ``seg`` [B, S] P is zeroed on every tile where a
    row's and a key's ids differ."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    sl2 = scale * LOG2E
    dq = torch.full((b, sq, hq, d), float("nan"))
    for bb, h, q0 in _dq_grid(b, sq, hq):
        hk = h // (hq // hkv)
        for r0 in (q0, q0 + 64):  # one consumer warpgroup's 64 rows
            qt, dot = _rows(q[bb, :, h], r0, 64), _rows(do[bb, :, h], r0, 64)
            row = r0 + torch.arange(64)
            l2 = _rows(lse[bb, h], r0, 64) * LOG2E
            dr = _rows(dd[bb, h], r0, 64)
            end = min(sk, r0 + 64) if causal else sk
            acc = torch.zeros(64, d)
            for k0 in range(0, end, TILE):
                kt, vt = _rows(k[bb, :, hk], k0, TILE), _rows(v[bb, :, hk], k0, TILE)
                p = torch.exp2((qt @ kt.T) * sl2 - l2[:, None])
                if k0 + TILE > sk or (causal and k0 + TILE - 1 > r0):
                    key = k0 + torch.arange(TILE)
                    hide = key[None] >= sk
                    if causal:
                        hide = hide | (key[None] > row[:, None])
                    p = p.masked_fill(hide, 0.0)
                if seg is not None:
                    other = (_seg_rows(seg, bb, k0, TILE)[None]
                             != _seg_rows(seg, bb, r0, 64)[:, None])
                    p = p.masked_fill(other, 0.0)
                ds = p * (dot @ vt.T - dr[:, None])
                acc += _bf16(ds) @ kt
            n = max(0, min(64, sq - r0))
            dq[bb, r0:r0 + n, h] = (scale * acc)[:n]
    return dq


def _emulate_dkv(q, k, v, do, lse, dd, causal, scale, seg=None):
    """K3's algorithm on f32 copies of bf16 inputs: (dk, dv) [B, Sk, Hkv,
    D], each summed over the kv head's query heads; segment ids as in
    :func:`_emulate_dq` (K3 reads the query tile's ids staged beside its
    lse and D rows)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    sl2 = scale * LOG2E
    dk = torch.full((b, sk, hkv, d), float("nan"))
    dv = torch.full((b, sk, hkv, d), float("nan"))
    for bb, hk, k0 in _dkv_grid(b, sk, hkv):
        q_begin = k0 if causal else 0
        for kw0 in (k0, k0 + 64):  # one consumer warpgroup's 64 keys
            kt, vt = _rows(k[bb, :, hk], kw0, 64), _rows(v[bb, :, hk], kw0, 64)
            key = kw0 + torch.arange(64)
            dka, dva = torch.zeros(64, d), torch.zeros(64, d)
            for h in range(hk * groups, (hk + 1) * groups):
                for q0 in range(q_begin, sq, TILE):
                    if causal and q0 + TILE <= kw0:
                        continue  # every query of the tile lies above its keys
                    qt, dot = _rows(q[bb, :, h], q0, TILE), _rows(do[bb, :, h], q0, TILE)
                    qi = q0 + torch.arange(TILE)
                    l2 = _rows(lse[bb, h], q0, TILE) * LOG2E
                    dc = _rows(dd[bb, h], q0, TILE)
                    pt = torch.exp2((kt @ qt.T) * sl2 - l2[None])
                    if q0 + TILE > sq or kw0 + 64 > sk or (causal and q0 < kw0 + 63):
                        hide = (qi[None] >= sq) | (key[:, None] >= sk)
                        if causal:
                            hide = hide | (key[:, None] > qi[None])
                        pt = pt.masked_fill(hide, 0.0)
                    if seg is not None:
                        other = (_seg_rows(seg, bb, kw0, 64)[:, None]
                                 != _seg_rows(seg, bb, q0, TILE)[None])
                        pt = pt.masked_fill(other, 0.0)
                    dva += _bf16(pt) @ dot
                    dst = pt * (vt @ dot.T - dc[None])
                    dka += _bf16(dst) @ qt
            n = max(0, min(64, sk - kw0))
            dk[bb, kw0:kw0 + n, hk] = (scale * dka)[:n]
            dv[bb, kw0:kw0 + n, hk] = dva[:n]
    return dk, dv


def _row_err(x, ref, floor_of=None):
    """Largest ||x - ref|| / ||ref|| over rows, ||ref|| raised to ROW_FLOOR
    of the largest row norm of ``floor_of`` (default: ref)."""
    scale_rows = (ref if floor_of is None else floor_of).norm(dim=-1)
    denom = ref.norm(dim=-1).clamp_min(ROW_FLOOR * scale_rows.max().item())
    return ((x - ref).norm(dim=-1) / denom).max().item()


def _uncancelled(q, k, v, do, scale):
    """For causal S 1: scale * dP * K and scale * dP * Q, what dq and dk
    would be without the cancellation dS = P (dP - D) = 0."""
    hkv = k.shape[2]
    dp = (do * v.repeat_interleave(q.shape[2] // hkv, dim=2)).sum(-1, keepdim=True)
    dq = scale * dp * k.repeat_interleave(q.shape[2] // hkv, dim=2)
    dk = scale * (dp * q).reshape(*k.shape[:2], hkv, -1, k.shape[-1]).sum(3)
    return dq, dk


def _bf16_inputs(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16().float()
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


@pytest.mark.parametrize("b,sq,hq", [(2, 1, 3), (1, 64, 2), (2, 129, 4),
                                     (3, 1000, 2), (1, 2047, 1)])
def test_dq_grid_covers_every_row_once(b, sq, hq):
    blocks = _dq_grid(b, sq, hq)
    seen = np.zeros((b, hq, sq), np.int64)
    for bb, h, q0 in blocks:
        seen[bb, h, q0:q0 + BLOCK] += 1
    assert (seen == 1).all()
    # the last (causally heaviest) query block launches first
    assert blocks[0][2] == max(q0 for _, _, q0 in blocks)


@pytest.mark.parametrize("b,sk,hkv", [(2, 1, 3), (1, 64, 2), (2, 129, 4),
                                      (3, 1000, 2), (8, 2048, 8)])
def test_dkv_grid_covers_every_key_once(b, sk, hkv):
    blocks = _dkv_grid(b, sk, hkv)
    seen = np.zeros((b, hkv, sk), np.int64)
    for bb, hk, k0 in blocks:
        seen[bb, hk, k0:k0 + BLOCK] += 1
    assert (seen == 1).all()
    # the key blocks of one (batch, kv head) launch together, the first
    # keys (which see the most query tiles) first
    nx = -(-sk // BLOCK)
    for i in range(0, len(blocks), nx):
        group = blocks[i:i + nx]
        assert len({(bb, hk) for bb, hk, _ in group}) == 1
        assert [k0 for _, _, k0 in group] == [x * BLOCK for x in range(nx)]


@pytest.mark.parametrize("sq,sk,hq,hkv,causal", [
    (1, 1, 8, 2, True), (65, 65, 6, 2, True), (129, 129, 8, 2, True),
    (200, 200, 6, 2, True), (100, 237, 8, 2, False)])
def test_flash_bwd_emulation_matches_plain_and_jax(sq, sk, hq, hkv, causal):
    """B 2, D 32 (the algorithm does not depend on D; the kernels are
    built for 128). The JAX side runs the Pallas kernels in interpret mode
    with one block per sequence (its row slices need blocks that divide
    S); the forward out and lse come from it for all three."""
    b, d = 2, 32
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _bf16_inputs(sq + sk + hq, b, sq, sk, hq, hkv, d)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    j_out, j_lse = jattn._flash_forward(jq, jk, jv, causal, scale, sq, sk,
                                        interpret=True, with_residuals=True)
    j_dd = jattn.compute_dd(j_out, jdo)
    jax_grads = [torch.from_numpy(np.array(x)) for x in jattn._flash_backward(
        jq, jk, jv, j_dd, j_lse, jdo, causal, scale, sq, sk, interpret=True)]
    out = torch.from_numpy(np.array(j_out))
    lse = torch.from_numpy(np.array(j_lse)).reshape(b, hq, sq)
    plain = tattn.flash_bwd_plain(q, k, v, out, lse, do, causal, scale)
    for x, y in zip(plain, jax_grads):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)

    dd = tattn.compute_dd(out, do)
    dq = _emulate_dq(q, k, v, do, lse, dd, causal, scale)
    dk, dv = _emulate_dkv(q, k, v, do, lse, dd, causal, scale)
    floors = (_uncancelled(q, k, v, do, scale) if causal and sq == 1
              else (None, None)) + (None,)
    for want in (plain, jax_grads):
        for name, x, ref, fl in zip(("dq", "dk", "dv"), (dq, dk, dv), want, floors):
            assert torch.isfinite(x).all(), name
            assert _row_err(x, ref, fl) <= ROW_TOL, (name, _row_err(x, ref, fl))


@pytest.mark.parametrize("d,hq,hkv,causal", [(64, 2, 2, False), (64, 4, 2, True),
                                             (128, 4, 2, True)])
def test_flash_bwd_emulation_with_segment_ids_matches_plain_and_jax(d, hq, hkv, causal):
    """Segment ids (three documents per row, cut inside and across the
    64-row tiles), B 2, S 200, at head dims 64 and 128; the JAX side in
    interpret mode with one block per sequence."""
    b, s = 2, 200
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _bf16_inputs(d + hq + 1, b, s, s, hq, hkv, d)
    seg = torch.zeros(b, s, dtype=torch.int32)
    seg[0, :70], seg[0, 70:90], seg[0, 90:] = 1, 2, 3
    seg[1, :10], seg[1, 10:150], seg[1, 150:] = 1, 2, 3
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jseg = jnp.asarray(seg.numpy())
    j_out, j_lse = jattn._flash_forward(jq, jk, jv, causal, scale, s, s,
                                        interpret=True, with_residuals=True,
                                        segment_ids=jseg)
    j_dd = jattn.compute_dd(j_out, jdo)
    jax_grads = [torch.from_numpy(np.array(x)) for x in jattn._flash_backward(
        jq, jk, jv, j_dd, j_lse, jdo, causal, scale, s, s, interpret=True,
        segment_ids=jseg)]
    out = torch.from_numpy(np.array(j_out))
    lse = torch.from_numpy(np.array(j_lse)).reshape(b, hq, s)
    plain = tattn.flash_bwd_plain(q, k, v, out, lse, do, causal, scale, seg)
    for x, y in zip(plain, jax_grads):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)
    dd = tattn.compute_dd(out, do)
    dq = _emulate_dq(q, k, v, do, lse, dd, causal, scale, seg)
    dk, dv = _emulate_dkv(q, k, v, do, lse, dd, causal, scale, seg)
    for want in (plain, jax_grads):
        for name, x, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert torch.isfinite(x).all(), name
            assert _row_err(x, ref) <= ROW_TOL, (name, _row_err(x, ref))
    # the mask matters: without it the emulations are far off
    assert _row_err(_emulate_dq(q, k, v, do, lse, dd, causal, scale), plain[0]) > ROW_TOL
    assert _row_err(_emulate_dkv(q, k, v, do, lse, dd, causal, scale)[1],
                    plain[2]) > ROW_TOL


def test_emulation_fails_without_the_masks():
    """The comparison is not vacuous: either emulation without its causal
    mask and start (keys after a query row leaking in) is far outside the
    limit."""
    b, s, hq, hkv, d = 1, 200, 2, 1, 32
    scale = d ** -0.5
    q, k, v, do = _bf16_inputs(1, b, s, s, hq, hkv, d)
    out, lse = tattn.flash_fwd_plain(q, k, v, True, scale)
    dd = tattn.compute_dd(out, do)
    ref = tattn.flash_bwd_plain(q, k, v, out, lse, do, True, scale)
    leaky = _emulate_dq(q, k, v, do, lse, dd, False, scale)
    assert _row_err(leaky, ref[0]) > ROW_TOL
    leaky_k, leaky_v = _emulate_dkv(q, k, v, do, lse, dd, False, scale)
    assert _row_err(leaky_k, ref[1]) > ROW_TOL
    assert _row_err(leaky_v, ref[2]) > ROW_TOL


@pytest.mark.parametrize("sq", [1, 4, 65, 2047, 2048])
def test_lse_rows_padded_to_a_tma_stride(sq):
    """The kernels read lse and D through a TMA map whose row stride must
    be a multiple of 16 bytes: rows are padded to a multiple of 4 f32 (a
    copy only when Sq is not one already), the data unchanged."""
    x = torch.randn(2, 3, sq)
    padded = tattn._tma_rows(x)
    stride = tattn._tma_row_stride(sq)
    assert stride % 4 == 0 and sq <= stride < sq + 4
    assert padded.shape == (2, 3, stride) and padded.is_contiguous()
    assert torch.equal(padded[..., :sq], x)
    assert (padded is x) == (stride == sq)
