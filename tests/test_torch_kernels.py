"""The port's CUDA kernels on the card, and the port's import hygiene.

This file imports no JAX, so it also runs on a machine with a card and
no JAX (the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tests marked ``gpu`` hold each kernel against its plain PyTorch version
computed in f32, at the serving and training shapes, with chip_smoke.py's
limits (the largest row error ||out - ref|| / ||ref||: 8e-3 for the flash
forward, which also rounds P to bf16, 5e-3 for decode, 1e-2 for each of
dq, dk and dv of the flash backward, which rounds P and dS to bf16; f32
lse 1e-4 absolute); without a CUDA device they skip.
"""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from chip_smoke import (DECODE_REL_TOL, FLASH_BWD_REL_TOL,
                        FLASH_BWD_ROW_FLOOR, FLASH_LSE_TOL, FLASH_REL_TOL,
                        row_rel_err)
from k8s_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                        check_cuda_config)
from k8s_tpu_torch.ops import attention as tattn

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_package_imports_no_jax_flax_or_triton():
    """Importing the port and every submodule loads none of JAX, flax,
    triton or the JAX package (a fresh interpreter), and no source of
    the port or of chip_smoke.py imports JAX or the JAX package."""
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
    sources = list((REPO / "k8s_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if bad.search(p.read_text())]
    assert not offenders, offenders


def test_cuda_config_check_refuses_configs_without_a_kernel():
    """On the card the model serves only what both kernels are built for
    (bf16, head_dim 128, 4 q heads per kv head): tiny's head_dim 32, an
    f32 model or another group size raise instead of running plain
    attention there. Pure config logic, so it runs here too."""
    check_cuda_config(LlamaConfig.llama3_8b())
    for cfg in (LlamaConfig.tiny(),
                LlamaConfig.tiny(dtype=torch.bfloat16),
                LlamaConfig.llama3_8b(dtype=torch.float32),
                LlamaConfig.llama3_8b(num_kv_heads=4)):
        with pytest.raises(ValueError, match="no CUDA kernel instance"):
            check_cuda_config(cfg)


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
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros(1, 16, 4, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.flash_attention(q, q, q)  # head dim 32: no kernel
    with pytest.raises(ValueError, match="no CUDA kernel instance"):
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16), device=cuda)
    f32 = torch.zeros(1, 16, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        tattn.flash_fwd(f32, f32, f32, True, 1.0)
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
