"""The port's CUDA kernels on the card, the wrappers' device guard, and
the port's import hygiene.

This file imports no JAX, so it also runs on a machine with a card and
no JAX (the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tests marked ``gpu`` hold each kernel against its plain PyTorch version
computed in f32, at the serving and training shapes, with chip_smoke.py's
limits (the largest row error ||out - ref|| / ||ref||: 8e-3 for the flash
forward, which also rounds P to bf16, 5e-3 for decode over a bf16 or an
int8 cache, 1e-2 for each of dq, dk and dv of the flash backward, which
rounds P and dS to bf16; f32 lse 1e-4 absolute; the int8 rows and
scales the int8-KV decode kernel appends bit-equal); without a CUDA
device they skip. The device-guard tests run here: the guard, the
stream lookup and the kernel libraries are stubbed.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest
import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import (DECODE_Q8_REL_TOL, DECODE_REL_TOL, FLASH_BWD_REL_TOL,
                        FLASH_BWD_ROW_FLOOR, FLASH_LSE_TOL, FLASH_REL_TOL,
                        row_rel_err, uncancelled_dq_dk)
from k8s_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                        check_cuda_config)
from k8s_tpu_torch.ops import _kernels
from k8s_tpu_torch.ops import attention as tattn

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_package_imports_no_jax_flax_or_triton():
    """Importing the port and every submodule loads none of JAX, flax,
    triton or the JAX package (a fresh interpreter), and no source of
    the port or of chip_smoke.py imports JAX or the JAX package. Every
    ``.py`` under ``k8s_tpu_torch/`` is a source, except what lies in
    the kernels' git-ignored build directory (``_kernels.BUILD_DIR``),
    where probe scripts and unpacked copies of the tree may sit; the
    walk needs no git, so it also runs on an unpacked archive."""
    code = (
        "import importlib, pkgutil, sys, k8s_tpu_torch\n"
        "for m in pkgutil.walk_packages(k8s_tpu_torch.__path__, "
        "'k8s_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted({'jax', 'flax', 'triton', 'k8s_tpu'} & set(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|k8s_tpu)(\.|\s|$)", re.M)
    build = _kernels.BUILD_DIR
    assert build == REPO / "k8s_tpu_torch" / "build"
    sources = [p for p in (REPO / "k8s_tpu_torch").rglob("*.py")
               if not p.is_relative_to(build)]
    assert REPO / "k8s_tpu_torch" / "ops" / "attention.py" in sources
    sources.append(REPO / "chip_smoke.py")
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if bad.search(p.read_text())]
    assert not offenders, offenders


def test_cuda_config_check_refuses_configs_without_a_kernel():
    """On the card the model runs only what its kernels are built for
    (bf16, head_dim 128; for serving also 4 q heads per kv head): tiny's
    head_dim 32, an f32 model or a serving config with another group
    size raise instead of running plain attention there. Pure config
    logic, so it runs here too."""
    check_cuda_config(LlamaConfig.llama3_8b())
    check_cuda_config(LlamaConfig.llama3_8b(decode=True, kv_quant="int8",
                                            quant="int8_serving"))
    for cfg in (LlamaConfig.tiny(),
                LlamaConfig.tiny(dtype=torch.bfloat16),
                LlamaConfig.tiny(dtype=torch.bfloat16, kv_quant="int8"),
                LlamaConfig.llama3_8b(dtype=torch.float32),
                LlamaConfig.llama3_8b(num_kv_heads=4, decode=True)):
        with pytest.raises(ValueError, match="no CUDA kernel instance"):
            check_cuda_config(cfg)


# the training cell of benches/llama_bench.py: 12 q heads over 4 kv heads
_G3 = dict(vocab_size=32768, hidden_size=1536, intermediate_size=4096,
           num_layers=24, num_heads=12, num_kv_heads=4, head_dim=128)


@pytest.mark.parametrize("cfg", [
    LlamaConfig(**_G3), LlamaConfig(**_G3, remat_policy="flash"),
    LlamaConfig.llama3_8b(num_kv_heads=4), LlamaConfig.llama3_8b(num_kv_heads=32),
], ids=["g3", "g3_flash_remat", "g8", "g1"])
def test_cuda_config_check_holds_training_to_the_flash_kernels_only(cfg):
    """A training config needs K1-K3 only, which take the group size at
    run time: Hq 12 / Hkv 4 (G 3), G 8 and G 1 in bf16 at head_dim 128
    pass; the same heads in a decode config are refused by name of the
    decode kernels, which are instantiated for G 4 only."""
    check_cuda_config(cfg)
    serving = dataclasses.replace(cfg, decode=True, ragged_decode=True)
    with pytest.raises(ValueError, match=r"no CUDA kernel instance.*decode "
                                         r"kernels \(K4, K5\)"):
        check_cuda_config(serving)
    with pytest.raises(ValueError, match="decode kernels"):
        check_cuda_config(dataclasses.replace(serving, kv_quant="int8"))


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
@pytest.mark.parametrize("bad", [dict(head_dim=64), dict(head_dim=96),
                                 dict(dtype=torch.float32),
                                 dict(num_heads=12, num_kv_heads=5)],
                         ids=["d64", "d96", "f32", "g2.4"])
def test_cuda_config_check_refuses_unbuilt_head_dims_and_dtypes(decode, bad):
    """Any config, training or decode, with a head dim, dtype or head
    split no kernel is built for is refused, naming the kernel family
    that refused it."""
    cfg = LlamaConfig.llama3_8b(decode=decode, **bad)
    family = "decode kernels" if decode else r"flash kernels \(K1-K3\)"
    with pytest.raises(ValueError, match=f"no CUDA kernel instance.*{family}"):
        check_cuda_config(cfg)


class _OnCard1(torch.Tensor):
    """A CPU tensor that reports itself on ``cuda:1``: the wrappers take
    their CUDA path with it, while its data stay readable here."""

    @property
    def device(self):
        return torch.device("cuda", 1)

    @property
    def is_cuda(self):
        return True


class _CardAllocsOnCpu(TorchFunctionMode):
    """Allocations the wrappers make on their tensors' CUDA device land on
    the CPU instead (this build of torch has no CUDA)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.get("device") is not None and torch.device(kwargs["device"]).type == "cuda":
            kwargs["device"] = "cpu"
        return func(*args, **kwargs)


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda.device, the stream lookup and the kernel libraries
    stubbed: returns the log of guard entries and exits, stream lookups
    and C entry calls, in order, and a maker of cuda:1 tensors."""
    log = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            log.append(("enter", self.device))

        def __exit__(self, *exc):
            log.append(("exit", self.device))

    class Stream:
        def __init__(self, device):
            log.append(("stream", device))
            self.cuda_stream = 0x5EED

    class Lib:
        def __getattr__(self, entry):
            def call(*args):
                log.append(("call", entry, args))
                return 0
            return call

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_kernels, "lib", lambda name: Lib())
    # the stubbed calls tick the wrappers' launch counters: put them back
    # afterwards, as other tests in the process read them
    for wrapper, counters in ((tattn.flash_fwd, ("launches",)),
                              (tattn.flash_bwd, ("launches_dq", "launches_dkv")),
                              (tattn.decode_attention_update, ("launches",)),
                              (tattn.decode_attention_update_q8, ("launches",))):
        for counter in counters:
            monkeypatch.setattr(wrapper, counter, getattr(wrapper, counter))
    gen = torch.Generator().manual_seed(0)

    def card(*shape, dtype=torch.bfloat16):
        x = torch.randn(shape, generator=gen).to(dtype)
        return x.as_subclass(_OnCard1)

    with _CardAllocsOnCpu():
        yield log, card


def _flash_fwd_call(card):
    q, k, v = card(1, 16, 8, 128), card(1, 16, 2, 128), card(1, 16, 2, 128)
    tattn.flash_fwd(q, k, v, True, 0.125)


def _flash_bwd_call(card):
    q, k, v, o = card(1, 16, 8, 128), card(1, 16, 2, 128), card(1, 16, 2, 128), card(1, 16, 8, 128)
    tattn.flash_bwd(q, k, v, o, card(1, 8, 16, dtype=torch.float32), card(1, 16, 8, 128),
                    True, 0.125)


def _decode_call(card):
    tattn.decode_attention_update(card(2, 8, 128), card(2, 2, 128), card(2, 2, 128),
                                  card(2, 2, 64, 128), card(2, 2, 64, 128), 3)


def _decode_q8_call(card):
    tattn.decode_attention_update_q8(
        card(2, 8, 128), card(2, 2, 128), card(2, 2, 128),
        card(2, 2, 64, 128, dtype=torch.int8), card(2, 2, 64, 128, dtype=torch.int8),
        card(2, 2, 64, dtype=torch.float32), card(2, 2, 64, dtype=torch.float32), 3)


@pytest.mark.parametrize("call,entries", [
    (_flash_fwd_call, ["k8s_flash_fwd_bf16"]),
    (_flash_bwd_call, ["k8s_flash_bwd_dq_bf16", "k8s_flash_bwd_dkv_bf16"]),
    (_decode_call, ["k8s_decode_attn_bf16"]),
    (_decode_q8_call, ["k8s_decode_attn_q8"]),
])
def test_wrappers_launch_under_their_tensors_device_guard(fake_card, call, entries):
    """Every C entry is called inside ``torch.cuda.device(<the tensors'
    device>)`` — a C entry launches on the runtime's current device — with
    that device's current stream as its last argument. Runs here: the
    guard, the stream lookup and the libraries are stubbed, and the
    tensors report cuda:1."""
    log, card = fake_card
    call(card)
    dev = torch.device("cuda", 1)
    want = []
    for entry in entries:
        want += [("enter", dev), ("stream", dev), ("call", entry), ("exit", dev)]
    assert [e[:2] for e in log] == want
    assert all(e[2][-1] == 0x5EED for e in log if e[0] == "call")


def test_decode_split_rows_reach_the_c_entry(fake_card):
    """The decode wrappers pass _decode_split_rows's C (or a forced one) and
    a workspace of ceil(S / C) splits to the C entry; a split length that
    is not one of DECODE_SPLIT_ROWS raises."""
    log, card = fake_card
    args = (card(2, 8, 128), card(2, 2, 128), card(2, 2, 128),
            card(2, 2, 300, 128), card(2, 2, 300, 128), 3)
    tattn.decode_attention_update(*args)
    tattn.decode_attention_update(*args, split_rows=256)
    calls = [e[2] for e in log if e[0] == "call"]
    # ..., B, Hkv, G, S, D, C, scale, stream
    assert [c[-8:-2] for c in calls] == [
        (2, 2, 4, 300, 128, tattn._decode_split_rows(2, 2, 300)),
        (2, 2, 4, 300, 128, 256)]
    with pytest.raises(ValueError, match="split_rows"):
        tattn.decode_attention_update(*args, split_rows=100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _f32(*xs):
    return [x.float() for x in xs]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [16, 100, 256])
def test_flash_kernel_matches_plain_on_card(cuda, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16()
               for shape in ((2, s, 32, 128), (2, s, 8, 128), (2, s, 8, 128)))
    n0 = tattn.flash_fwd.launches
    out, lse = tattn.flash_fwd(q, k, v, True, 128 ** -0.5, with_lse=True)
    ref, ref_lse = tattn.flash_fwd_plain(*_f32(q, k, v), True, 128 ** -0.5)
    assert tattn.flash_fwd.launches == n0 + 1
    assert row_rel_err(out, ref) <= FLASH_REL_TOL
    assert (lse - ref_lse).abs().max().item() <= FLASH_LSE_TOL
    # non-causal, Sq != Sk
    kv = torch.randn((2, s + 37, 8, 128), generator=g, device=cuda).bfloat16()
    out = tattn.flash_fwd(q, kv, kv, False, 0.125)
    ref, _ = tattn.flash_fwd_plain(*_f32(q, kv, kv), False, 0.125)
    assert row_rel_err(out, ref) <= FLASH_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("config", [0, 1])
@pytest.mark.parametrize("sq,sk,causal,fused", [
    (129, 129, True, False), (1000, 1000, True, False),
    (2047, 2047, True, False), (300, 777, False, False),
    (1000, 1000, True, True)])
def test_flash_kernel_tiling_edges_on_card(cuda, config, sq, sk, causal, fused):
    """K1 under both tile configs at B 2: ragged tails (lengths that are
    not multiples of 128), Sq != Sk non-causal, and q/k/v as strided
    views of one fused [B, S, Hq + 2 Hkv, D] tensor (the tensor maps'
    strides)."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).bfloat16()  # noqa: E731
    if fused:
        qkv = rnd(2, sq, 48, 128)
        q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    else:
        q, k, v = rnd(2, sq, 32, 128), rnd(2, sk, 8, 128), rnd(2, sk, 8, 128)
    out, lse = tattn.flash_fwd(q, k, v, causal, 128 ** -0.5, with_lse=True,
                               config=config)
    ref, ref_lse = tattn.flash_fwd_plain(*_f32(q, k, v), causal, 128 ** -0.5)
    assert out.is_contiguous() and out.shape == q.shape
    assert row_rel_err(out, ref) <= FLASH_REL_TOL
    assert (lse - ref_lse).abs().max().item() <= FLASH_LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("s,sk,causal", [(128, 128, True), (1000, 1000, True),
                                         (200, 237, False)])
def test_flash_bwd_kernels_match_plain_on_card(cuda, s, sk, causal):
    """K2 (dq) and K3 (dk/dv, summed over the group of 4 query heads)
    against the plain backward in f32 on the same bf16 inputs and the
    same forward out/lse; a ragged tail at S=1000 and Sq != Sk
    non-causal."""
    g = torch.Generator(device=cuda).manual_seed(s)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).bfloat16()  # noqa: E731
    q, do = rnd(2, s, 32, 128), rnd(2, s, 32, 128)
    k, v = rnd(2, sk, 8, 128), rnd(2, sk, 8, 128)
    scale = 128 ** -0.5
    out, lse = tattn.flash_fwd(q, k, v, causal, scale, with_lse=True)
    n_dq, n_dkv = tattn.flash_bwd.launches_dq, tattn.flash_bwd.launches_dkv
    got = tattn.flash_bwd(q, k, v, out, lse, do, causal, scale)
    want = tattn.flash_bwd_plain(*_f32(q, k, v, out), lse, do.float(),
                                 causal, scale)
    assert (tattn.flash_bwd.launches_dq, tattn.flash_bwd.launches_dkv) == (
        n_dq + 1, n_dkv + 1)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and x.shape == ref.shape, name
        err = row_rel_err(x, ref, floor=FLASH_BWD_ROW_FLOOR)
        assert err <= FLASH_BWD_REL_TOL, (name, err)


def _bwd_inputs(cuda, seed, sq, sk, hq, hkv, fused):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).bfloat16()  # noqa: E731
    if fused:
        qkv = rnd(2, sq, hq + 2 * hkv, 128)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    else:
        q, k, v = rnd(2, sq, hq, 128), rnd(2, sk, hkv, 128), rnd(2, sk, hkv, 128)
    return q, k, v, rnd(2, sq, hq, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,hq,hkv,causal,fused", [
    (1, 1, 32, 8, True, False), (65, 65, 32, 8, True, False),
    (129, 129, 32, 8, True, False), (1000, 1000, 32, 8, True, False),
    (2047, 2047, 32, 8, True, False), (300, 777, 32, 8, False, False),
    (1000, 1000, 32, 8, True, True), (1000, 1000, 12, 4, True, False)])
def test_flash_bwd_kernels_tiling_edges_on_card(cuda, sq, sk, hq, hkv, causal, fused):
    """K2 and K3 at the edges of their tiling, B 2: lengths that are not
    multiples of the 128-row blocks or 64-row tiles (and S 1), Sq != Sk
    non-causal, q/k/v as strided views of one fused [B, S, Hq + 2 Hkv, D]
    tensor, and 3 query heads per kv head. At causal S 1 dq and dk vanish
    in exact math (dS = dP - D = 0), so their floor is taken from the
    uncancelled terms (chip_smoke.uncancelled_dq_dk)."""
    q, k, v, do = _bwd_inputs(cuda, sq + sk + hq, sq, sk, hq, hkv, fused)
    scale = 128 ** -0.5
    out, lse = tattn.flash_fwd(q, k, v, causal, scale, with_lse=True)
    got = tattn.flash_bwd(q, k, v, out, lse, do, causal, scale)
    want = tattn.flash_bwd_plain(*_f32(q, k, v, out), lse, do.float(),
                                 causal, scale)
    floors = (uncancelled_dq_dk(q, k, v, do, scale) if causal and sq == 1
              else (None, None)) + (None,)
    for name, x, ref, fl in zip(("dq", "dk", "dv"), got, want, floors):
        assert x.dtype == torch.bfloat16 and x.shape == ref.shape, name
        assert x.is_contiguous(), name
        err = row_rel_err(x, ref, floor=FLASH_BWD_ROW_FLOOR, floor_of=fl)
        assert err <= FLASH_BWD_REL_TOL, (name, err)


@pytest.mark.gpu
def test_flash_bwd_kernels_bit_identical_on_repeat(cuda):
    """No atomics: every gradient element is written once by one block,
    so two calls on the same inputs give bit-identical dq, dk and dv."""
    q, k, v, do = _bwd_inputs(cuda, 11, 1000, 1000, 32, 8, False)
    out, lse = tattn.flash_fwd(q, k, v, True, 128 ** -0.5, with_lse=True)
    first = tattn.flash_bwd(q, k, v, out, lse, do, True, 128 ** -0.5)
    second = tattn.flash_bwd(q, k, v, out, lse, do, True, 128 ** -0.5)
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.gpu
def test_flash_attention_autograd_on_card(cuda):
    """flash_attention's gradients on the card go through the custom op:
    one K1 launch forward, one K2 and one K3 backward, and the
    gradients equal the plain backward of what the op saw — the bf16
    forward output and lse, and the bf16 output gradient (the exact f32
    gradient differs by that rounding, which early causal rows amplify
    through the cancellation in dP - D, in the JAX kernels as here)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(sh, generator=g, device=cuda).bfloat16()
               for sh in ((2, 300, 32, 128), (2, 300, 8, 128), (2, 300, 8, 128)))
    w = torch.randn((2, 300, 32, 128), generator=g, device=cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = (tattn.flash_fwd.launches, tattn.flash_bwd.launches_dq,
              tattn.flash_bwd.launches_dkv)
    (tattn.flash_attention(*leaves).float() * w).sum().backward()
    assert (tattn.flash_fwd.launches, tattn.flash_bwd.launches_dq,
            tattn.flash_bwd.launches_dkv) == tuple(n + 1 for n in counts)
    scale = 128 ** -0.5
    out, lse = tattn.flash_fwd(q, k, v, True, scale, with_lse=True)
    want = tattn.flash_bwd_plain(*_f32(q, k, v, out), lse,
                                 w.bfloat16().float(), True, scale)
    for name, x, ref in zip(("dq", "dk", "dv"), leaves, want):
        err = row_rel_err(x.grad, ref, floor=FLASH_BWD_ROW_FLOOR)
        assert err <= FLASH_BWD_REL_TOL, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("pos", [[0, 255, 7, 130], [64, 63, 1, 200]])
def test_decode_kernel_matches_plain_on_card(cuda, pos):
    g = torch.Generator(device=cuda).manual_seed(0)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).bfloat16()  # noqa: E731
    q, kn, vn = rnd(4, 32, 128), rnd(4, 8, 128), rnd(4, 8, 128)
    kc, vc = rnd(4, 8, 256, 128), rnd(4, 8, 256, 128)
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    n0 = tattn.decode_attention_update.launches
    out, k_out, _ = tattn.decode_attention_update(q, kn, vn, k1, v1, pos)
    ref = tattn.decode_attention_plain(*_f32(q, kn, vn), k2, v2, pos,
                                       128 ** -0.5)
    assert tattn.decode_attention_update.launches == n0 + 1
    assert k_out is k1  # in place
    assert row_rel_err(out, ref) <= DECODE_REL_TOL
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.gpu
@pytest.mark.parametrize("pos", [[0, 255, 7, 130], [64, 63, 1, 200]])
def test_decode_q8_kernel_matches_plain_on_card(cuda, pos):
    """K5 against its plain version on the same int8 cache: out within
    the decode limit, and the caches and scales after the append (the
    new row quantized in the kernel) bit-equal everywhere."""
    g = torch.Generator(device=cuda).manual_seed(1)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).bfloat16()  # noqa: E731
    q, kn, vn = rnd(4, 32, 128), rnd(4, 8, 128), rnd(4, 8, 128)
    kc, ks = tattn.quantize_kv_rows(rnd(4, 8, 256, 128))
    vc, vs = tattn.quantize_kv_rows(rnd(4, 8, 256, 128))
    pos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = [t.clone() for t in (kc, vc, ks, vs)]
    want = [t.clone() for t in (kc, vc, ks, vs)]
    n0 = tattn.decode_attention_update_q8.launches
    out, k_out, *_ = tattn.decode_attention_update_q8(q, kn, vn, *got, pos)
    ref = tattn.decode_attention_q8_plain(*_f32(q, kn, vn), *want, pos,
                                          128 ** -0.5)
    assert tattn.decode_attention_update_q8.launches == n0 + 1
    assert k_out is got[0]  # in place
    assert row_rel_err(out, ref) <= DECODE_Q8_REL_TOL
    at_pos = torch.zeros(4, 8, 256, dtype=torch.bool, device=cuda)
    at_pos[torch.arange(4, device=cuda), :, pos.long()] = True
    for x, y, old in zip(got, want, (kc, vc, ks, vs)):
        assert torch.equal(x, y)
        changed = (x != old).any(-1) if x.dim() == 4 else x != old
        assert not (changed & ~at_pos).any()  # only row pos[b] moved


def _decode_inputs(device, seed, b, s, q8):
    """q, k_new, v_new and the caches ([k, v] bf16, or [k, v, k_scale,
    v_scale] int8 with f32 row scales) at Hq 32, Hkv 8, D 128."""
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=device).bfloat16()  # noqa: E731
    q, kn, vn = rnd(b, 32, 128), rnd(b, 8, 128), rnd(b, 8, 128)
    kc, vc = rnd(b, 8, s, 128), rnd(b, 8, s, 128)
    if not q8:
        return q, kn, vn, [kc, vc]
    (kq, ks), (vq, vs) = tattn.quantize_kv_rows(kc), tattn.quantize_kv_rows(vc)
    return q, kn, vn, [kq, vq, ks, vs]


def _decode_kernel(q8):
    return tattn.decode_attention_update_q8 if q8 else tattn.decode_attention_update


def _decode_plain_f32(q, kn, vn, caches, pos, q8):
    """The plain version in f32 on copies of ``caches`` (which it appends
    to): ``(out, caches after the append)``."""
    pos_v = tattn._pos_vector(pos, q.shape[0], q.device)
    caches = [c.clone() for c in caches]
    args = [q.float(), kn.float(), vn.float()]
    if q8:
        out = tattn.decode_attention_q8_plain(*args, *caches, pos_v, 128 ** -0.5)
    else:
        out = tattn.decode_attention_plain(*args, *caches, pos_v, 128 ** -0.5)
    return out, caches


def _check_decode(q, kn, vn, caches, pos, q8, split_rows=None):
    """The kernel on copies of ``caches`` against the plain version: out
    within the decode limit, the caches after the append bit-equal (K4
    copies the new row, K5 quantizes it as quantize_kv_rows)."""
    got = [c.clone() for c in caches]
    out = _decode_kernel(q8)(q, kn, vn, *got, pos, split_rows=split_rows)[0]
    ref, want = _decode_plain_f32(q, kn, vn, caches, pos, q8)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    err = row_rel_err(out, ref)
    assert err <= (DECODE_Q8_REL_TOL if q8 else DECODE_REL_TOL), err
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rows", tattn.DECODE_SPLIT_ROWS)
def test_decode_kernels_split_boundaries_on_card(cuda, rows, q8):
    """K4 and K5 under each split length at B 8, S 2048: pos on split
    boundaries (C - 1, C, C + 1, S - C), 0, 1 and S - 2, S - 1."""
    s = 2048
    q, kn, vn, caches = _decode_inputs(cuda, rows, 8, s, q8)
    pos = torch.tensor([0, rows - 1, rows, rows + 1, s - rows, s - 2, s - 1, 1],
                       dtype=torch.int32, device=cuda)
    _check_decode(q, kn, vn, caches, pos, q8, split_rows=rows)


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_long_cache_on_card(cuda, q8):
    """16 slots of 8192 rows (the int8 serving cache) at ragged depths
    with 0 and S - 1, under _decode_split_rows's choice."""
    q, kn, vn, caches = _decode_inputs(cuda, 3, 16, 8192, q8)
    pos = torch.tensor([0, 8191, 1, 37, 500, 1024, 2047, 3000, 4095, 4500,
                        5000, 6000, 6500, 7000, 7777, 8190],
                       dtype=torch.int32, device=cuda)
    _check_decode(q, kn, vn, caches, pos, q8)


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_scalar_pos_on_card(cuda, q8):
    """A uniform batch: one scalar pos for every slot."""
    q, kn, vn, caches = _decode_inputs(cuda, 4, 4, 1024, q8)
    _check_decode(q, kn, vn, caches, 700, q8)


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_bit_identical_on_repeat(cuda, q8):
    """No atomics and a merge in a fixed order: two calls on the same
    inputs give bit-identical outputs and caches."""
    q, kn, vn, caches = _decode_inputs(cuda, 5, 8, 2048, q8)
    pos = torch.tensor([0, 2047, 1, 100, 513, 1024, 1500, 2000],
                       dtype=torch.int32, device=cuda)
    first, second = [c.clone() for c in caches], [c.clone() for c in caches]
    a = _decode_kernel(q8)(q, kn, vn, *first, pos)[0]
    b = _decode_kernel(q8)(q, kn, vn, *second, pos)[0]
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_decode_kernels_never_read_rows_past_pos(cuda, q8):
    """Cache rows at and past pos[b] hold NaN (K5: NaN row scales, int8
    has none): the output matches the plain version on a clean cache and
    is finite, and the append leaves the NaN rows past pos alone."""
    s = 1024
    q, kn, vn, caches = _decode_inputs(cuda, 6, 4, s, q8)
    pos = torch.tensor([0, 255, 256, 1023], dtype=torch.int32, device=cuda)
    ref, want = _decode_plain_f32(q, kn, vn, caches, pos, q8)
    past = torch.arange(s, device=cuda)[None, :] >= pos[:, None].long()  # [B, S]
    poisoned = [c.clone() for c in caches]
    for c in poisoned[2:] if q8 else poisoned:
        c[past[:, None].expand(c.shape[:3])] = float("nan")
    out = _decode_kernel(q8)(q, kn, vn, *poisoned, pos)[0]
    assert torch.isfinite(out).all()
    assert row_rel_err(out, ref) <= DECODE_REL_TOL
    at = ~past.clone()
    at[torch.arange(4, device=cuda), pos.long()] = True  # rows < pos and pos
    for x, w in zip(poisoned, want):
        assert torch.equal(x[at[:, None].expand(x.shape[:3])],
                           w[at[:, None].expand(w.shape[:3])])
    for x in poisoned[2:] if q8 else poisoned:
        assert x[(~at)[:, None].expand(x.shape[:3])].isnan().all()


@pytest.mark.gpu
def test_kernels_run_on_a_second_card(cuda):
    """K1, K4 and K5 on cuda:1 while cuda:0 is the current device: the
    wrappers launch under their tensors' device guard, and the flash
    kernel's shared-memory limit is set on that card too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(sh, generator=g, device=dev).bfloat16()
               for sh in ((2, 300, 32, 128), (2, 300, 8, 128), (2, 300, 8, 128)))
    for config in tattn.FLASH_FWD_TILES:
        out = tattn.flash_fwd(q, k, v, True, 128 ** -0.5, config=config)
        ref, _ = tattn.flash_fwd_plain(*_f32(q, k, v), True, 128 ** -0.5)
        assert out.device == dev and row_rel_err(out, ref) <= FLASH_REL_TOL
    for q8 in (False, True):
        qd, kn, vn, caches = _decode_inputs(dev, 9, 4, 1024, q8)
        pos = torch.tensor([0, 300, 511, 1023], dtype=torch.int32, device=dev)
        _check_decode(qd, kn, vn, caches, pos, q8)
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros(1, 16, 4, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.flash_attention(q, q, q)  # head dim 32: no kernel
    with pytest.raises(ValueError, match="no CUDA kernel instance"):
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16), device=cuda)
    f32 = torch.zeros(1, 16, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.flash_fwd(f32, f32, f32, True, 1.0)
    bf = f32.bfloat16()
    with pytest.raises(ValueError, match="scale > 0"):
        tattn.flash_fwd(bf, bf, bf, True, 0.0)
    with pytest.raises(ValueError, match="config"):
        tattn.flash_fwd(bf, bf, bf, True, 1.0, config=2)
    # the backward kernels: head dim 64 has no instance, f32 is refused
    q64 = torch.zeros(1, 16, 4, 64, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.flash_bwd(q64, q64, q64, q64, lse, q64, True, 0.125)
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.flash_bwd(f32, f32, f32, f32, lse, f32, True, 0.125)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.flash_attention(q64.requires_grad_(), q64, q64)
    qd = torch.zeros(2, 32, 128, dtype=torch.bfloat16, device=cuda)
    kn = torch.zeros(2, 2, 128, dtype=torch.bfloat16, device=cuda)  # G=16
    cache = torch.zeros(2, 2, 64, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.decode_attention_update(qd, kn, kn, cache, cache.clone(), 3)
    # the int8-KV kernel takes int8 caches and f32 scales only
    kn8 = torch.zeros(2, 8, 128, dtype=torch.bfloat16, device=cuda)
    c8 = torch.zeros(2, 8, 64, 128, dtype=torch.bfloat16, device=cuda)
    sc = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        tattn.decode_attention_update_q8(qd, kn8, kn8, c8, c8.clone(), sc,
                                         sc.clone(), 3)
