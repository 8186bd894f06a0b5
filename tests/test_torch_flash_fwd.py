"""The flash forward kernel's tiling (k8s_tpu_torch/csrc/flash_fwd.cu), on
the CPU.

The kernel itself runs only on the card (tests/test_torch_kernels.py and
chip_smoke.py hold it against its plain version there). Here:

- ``_flash_fwd_config`` picks 128-row query tiles when they fill the
  card and 64-row tiles otherwise, and the kernel's grid (q head, batch,
  query tiles last-first) covers every (b, h, q row) exactly once;
- an emulation of the kernel's algorithm — per block, 128-key tiles up
  to the diagonal, the mask applied only to a consumer warpgroup's
  64 rows on a tile that crosses the diagonal or the sequence end, the
  online softmax in base 2 with ``scale * log2(e)`` folded in, P rounded
  to bf16 for P V, lse converted back to natural log — matches
  ``flash_fwd_plain`` and the JAX package's ``_flash_forward`` run in
  interpret mode, at ragged lengths, Sq != Sk and 4 query heads per kv
  head;
- the kernels' build key covers the shared header.

Tolerances. Inputs are bf16 values held in f32, so both references are
exact f32 attention; the emulation differs from them only by rounding P
to bf16 (2^-9 relative per probability) before P V — 2.8e-3 to 3.1e-3
of a row's norm at the worst row of these shapes — so its rows are held
to 6e-3 (the card's limit is 8e-3, which also covers the bf16 output)
and its lse, computed in base 2 and converted, to 2e-5 absolute (a few
f32 ulps at |lse| ~ 5; observed 1e-6).
"""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.ops import attention as jattn
from k8s_tpu_torch.ops import _kernels
from k8s_tpu_torch.ops import attention as tattn

LOG2E = 1.4426950408889634
ROW_TOL = 6e-3
LSE_TOL = 2e-5


def _grid(b, sq, hq, config):
    """The kernel's blocks in launch order: blockIdx (x, y, z) = (q head,
    batch, query tile counted from the last) -> (b, h, q0)."""
    bm = tattn.FLASH_FWD_TILES[config][0]
    nz = -(-sq // bm)
    return [(y, x, (nz - 1 - z) * bm)
            for z in range(nz) for y in range(b) for x in range(hq)]


def _emulate(q, k, v, causal, scale, config, seg=None):
    """The kernel's algorithm on f32 copies of bf16 inputs: (out, lse).
    With segment ids ``seg`` [B, S] every tile is masked where a row's and
    a key's ids differ (ids past the end read as 0, never compared)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    bm, bn = tattn.FLASH_FWD_TILES[config]
    sl2 = scale * LOG2E
    out = torch.full((b, sq, hq, d), float("nan"))
    lse = torch.full((b, hq, sq), float("nan"))

    def rows(x, start, n):  # a TMA box: rows past the end read as zeros
        tile = torch.zeros(n, d)
        part = x[start:start + n]
        tile[:len(part)] = part
        return tile

    for bb, h, q0 in _grid(b, sq, hq, config):
        hk = h // (hq // hkv)
        qt = rows(q[bb, :, h], q0, bm)
        row = q0 + torch.arange(bm)
        if seg is not None:
            seg_row = rows(seg[bb, :, None].float(), q0, bm)[:, 0]
        m = torch.full((bm,), -math.inf)
        l = torch.zeros(bm)
        acc = torch.zeros(bm, d)
        kv_end = min(sk, q0 + bm) if causal else sk
        for k0 in range(0, kv_end, bn):
            kt, vt = rows(k[bb, :, hk], k0, bn), rows(v[bb, :, hk], k0, bn)
            s = qt @ kt.T
            key = k0 + torch.arange(bn)
            for wg0 in range(0, bm, 64):  # one consumer warpgroup's rows
                if (seg is not None or k0 + bn > sk
                        or (causal and k0 + bn - 1 > q0 + wg0)):
                    r = slice(wg0, wg0 + 64)
                    hide = key[None] >= sk
                    if causal:
                        hide = hide | (key[None] > row[r, None])
                    if seg is not None:
                        seg_key = rows(seg[bb, :, None].float(), k0, bn)[:, 0]
                        hide = hide | (seg_key[None] != seg_row[r, None])
                    s[r] = s[r].masked_fill(hide, -math.inf)
            mx = torch.maximum(m, s.max(-1).values)
            ms = torch.where(mx == -math.inf, torch.zeros(()), mx * sl2)
            corr = torch.exp2(m * sl2 - ms)
            p = torch.exp2(s * sl2 - ms[:, None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None] + p.bfloat16().float() @ vt
            m = mx
        n = min(bm, sq - q0)
        l = l.clamp_min(1e-30)
        out[bb, q0:q0 + n, h] = (acc / l[:, None])[:n]
        lse[bb, h, q0:q0 + n] = ((m * sl2 + torch.log2(l)) * math.log(2))[:n]
    return out, lse


def _row_err(out, ref):
    return ((out - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()


def _bf16_inputs(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16().float()
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


@pytest.mark.parametrize("b,sq,hq,want", [
    (1, 16, 32, 1), (1, 256, 32, 1),      # serving prefills: 32 / 64 blocks
    (1, 4096, 32, 0), (8, 2048, 32, 0),   # long prompt, training: 1024 / 4096
    (1, 384, 32, 1), (1, 385, 32, 0),     # 3 tiles x 32 = 96 blocks, 4 x 32 = 128
    (32, 128, 4, 0), (1, 128, 127, 1),    # 128 blocks exactly, and one short
])
def test_flash_fwd_config_choice(b, sq, hq, want):
    assert tattn._flash_fwd_config(b, sq, hq) == want


@pytest.mark.parametrize("config", sorted(tattn.FLASH_FWD_TILES))
@pytest.mark.parametrize("b,sq,hq", [(2, 1, 3), (1, 64, 2), (2, 129, 4),
                                     (3, 1000, 2), (1, 2047, 1)])
def test_flash_fwd_grid_covers_every_row_once(config, b, sq, hq):
    bm = tattn.FLASH_FWD_TILES[config][0]
    blocks = _grid(b, sq, hq, config)
    seen = np.zeros((b, hq, sq), np.int64)
    for bb, h, q0 in blocks:
        seen[bb, h, q0:q0 + bm] += 1
    assert (seen == 1).all()
    # the last (causally heaviest) query tile launches first
    assert blocks[0][2] == max(q0 for _, _, q0 in blocks)


@pytest.mark.parametrize("sq,sk,causal", [(129, 129, True), (200, 200, True),
                                          (100, 300, False)])
def test_flash_fwd_emulation_matches_plain_and_jax(sq, sk, causal):
    """Both tile configs, B 2, 8 query heads over 2 kv heads, D 32 (the
    algorithm does not depend on D; the kernel is built for 128)."""
    b, hq, hkv, d = 2, 8, 2, 32
    scale = 1.0 / math.sqrt(d)
    q, k, v = _bf16_inputs(sq + sk, b, sq, sk, hq, hkv, d)
    ref, ref_lse = tattn.flash_fwd_plain(q, k, v, causal, scale)
    j_out, j_lse = jattn._flash_forward(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal, scale, sq, sk,
        interpret=True, with_residuals=True)
    j_out = torch.from_numpy(np.array(j_out))
    j_lse = torch.from_numpy(np.array(j_lse)).reshape(b, hq, sq)
    np.testing.assert_allclose(ref.numpy(), j_out.numpy(), atol=1e-5)
    for config in tattn.FLASH_FWD_TILES:
        out, lse = _emulate(q, k, v, causal, scale, config)
        for want, want_lse in ((ref, ref_lse), (j_out, j_lse)):
            assert _row_err(out, want) <= ROW_TOL, config
            assert (lse - want_lse).abs().max().item() <= LSE_TOL, config


# segment ids per row: the second document of a row starts inside a key
# tile and the third past it, so some rows meet a whole 128-key tile they
# cannot see (the first tile, before any visible key: the running max
# stays -inf; or a later one: the max stays put)
SEGMENT_CUTS = ((0, 100, 140, 300), (0, 20, 200, 300))


def _cut_segments(b, s, cuts=SEGMENT_CUTS):
    seg = torch.zeros(b, s, dtype=torch.int32)
    for i in range(b):
        c = [x for x in cuts[i % len(cuts)] if x < s] + [s]
        for j in range(len(c) - 1):
            seg[i, c[j]:c[j + 1]] = j + 1
    return seg


@pytest.mark.parametrize("d,hq,hkv,causal", [(64, 2, 2, False), (64, 4, 2, True),
                                             (128, 4, 2, True)])
def test_flash_fwd_emulation_with_segment_ids_matches_plain_and_jax(d, hq, hkv, causal):
    """Segment ids, both tile configs, B 2, S 300, at head dims 64 and 128
    (the instances' D): rows meeting a whole key tile of another document
    keep a finite running max and a finite result."""
    b, s = 2, 300
    scale = 1.0 / math.sqrt(d)
    q, k, v = _bf16_inputs(d + hq, b, s, s, hq, hkv, d)
    seg = _cut_segments(b, s)
    ref, ref_lse = tattn.flash_fwd_plain(q, k, v, causal, scale, seg)
    j_out, j_lse = jattn._flash_forward(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal, scale, s, s,
        interpret=True, with_residuals=True, segment_ids=jnp.asarray(seg.numpy()))
    j_out = torch.from_numpy(np.array(j_out))
    j_lse = torch.from_numpy(np.array(j_lse)).reshape(b, hq, s)
    np.testing.assert_allclose(ref.numpy(), j_out.numpy(), atol=1e-5)
    for config in tattn.FLASH_FWD_TILES:
        out, lse = _emulate(q, k, v, causal, scale, config, seg)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all(), config
        for want, want_lse in ((ref, ref_lse), (j_out, j_lse)):
            assert _row_err(out, want) <= ROW_TOL, config
            assert (lse - want_lse).abs().max().item() <= LSE_TOL, config
    # the mask matters: the emulation without it is far off
    leaky, _ = _emulate(q, k, v, causal, scale, 0)
    assert _row_err(leaky, ref) > ROW_TOL


def test_emulation_fails_without_the_causal_mask():
    """The comparison is not vacuous: the emulation without its causal
    mask (keys after a row leaking in) is far outside the limit."""
    b, s, hq, hkv, d = 1, 200, 2, 1, 32
    q, k, v = _bf16_inputs(1, b, s, s, hq, hkv, d)
    ref, _ = tattn.flash_fwd_plain(q, k, v, True, d ** -0.5)
    leaky, _ = _emulate(q, k, v, False, d ** -0.5, 0)  # no causal mask at all
    assert _row_err(leaky, ref) > ROW_TOL


def test_library_path_covers_headers_and_flags(tmp_path, monkeypatch):
    """An edited header under csrc/ (hopper.cuh, which flash_fwd.cu
    includes) or another -I flag changes every library's path, so the
    build never reuses a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    paths = {n: _kernels.library_path(n) for n in _kernels.KERNELS}
    assert paths == {n: _kernels.library_path(n) for n in _kernels.KERNELS}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: _kernels.library_path(n) for n in _kernels.KERNELS}
    assert all(edited[n] != paths[n] for n in paths)
    monkeypatch.setattr(_kernels, "NVCC_FLAGS",
                        _kernels.NVCC_FLAGS + ["-I/usr/local/cutlass/include"])
    assert all(_kernels.library_path(n) != edited[n] for n in paths)
