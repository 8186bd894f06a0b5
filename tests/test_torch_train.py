"""PyTorch port of the training slice (k8s_tpu_torch: the flash backward,
the training forward with its remat policies, the train step, the
optimizer and the llama_train program), held to the JAX package on the
same numpy inputs.

Tolerances, all f32 on the CPU where the point is the algorithm:

- the flash backward's plain version against the JAX Pallas backward
  kernels in interpret mode, and the port's attention gradients against
  ``jax.grad`` of the JAX flash attention in interpret mode: atol 5e-5
  (the JAX package's own kernel-vs-reference bound, tests/test_dataplane.py;
  the same sums in another order over unit-normal inputs);
- the tiny Llama's loss and every parameter gradient against
  ``jax.value_and_grad`` of the flax model with fused CE: rtol 2e-4 and
  atol 2e-4 of the tensor's largest entry (two layers of the same f32
  math, another summation order; the atol covers entries near zero,
  whose sums cancel);
- three AdamW steps against ``optax.adamw``: rtol 1e-5, atol 1e-7 (the
  same update formula; sqrt and division round differently);
- gradient accumulation over 2 microbatches against the full batch:
  rtol 1e-5 and atol 1e-5 of the tensor's largest entry on the mean
  gradient (a mean of two half-batch means in place of one mean), and
  the lr (1e-2) on the Adam-updated parameters, since Adam maps a
  near-zero gradient entry to an update of about lr times its sign.
"""

import dataclasses
import json
import math
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_tpu.models import LlamaConfig as JaxConfig
from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.ops import attention as jattn
from k8s_tpu.ops.fused_ce import fused_lm_head_cross_entropy as jax_fused_ce
from k8s_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    init_params,
    params_from_jax,
)
from k8s_tpu_torch.models import llama as tllama
from k8s_tpu_torch.ops import attention as tattn
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.train import (
    TrainState,
    adamw,
    create_train_state,
    make_train_step,
    state_tree,
)

torch.set_num_threads(2)

ATTN_ATOL = 5e-5
GRAD_RTOL = 2e-4


def _normal(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# ---------------------------------------------------------------------------
# flash backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_pallas_interpret(causal):
    """GQA 8/4, D 64, S 256, 64-row q blocks and 128-key blocks on the
    JAX side (the dq kernel crosses kv blocks, the dk/dv kernel q
    blocks), from the same forward out and lse."""
    b, s, hq, hkv, d = 2, 256, 8, 4, 64
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = _normal(0, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 128,
                                    interpret=True, with_residuals=True)
    dd = jattn.compute_dd(out, jdo)
    want = jattn._flash_backward(jq, jk, jv, dd, lse, jdo, causal, scale,
                                 64, 128, interpret=True)
    t_out = torch.from_numpy(np.array(out))
    t_lse = torch.from_numpy(np.array(lse)).reshape(b, hq, s)
    np.testing.assert_allclose(
        tattn.compute_dd(t_out, torch.from_numpy(do)).numpy(),
        np.asarray(dd).reshape(b, hq, s), rtol=1e-5, atol=1e-5)
    got = tattn.flash_bwd(*_t(q, k, v), t_out, t_lse, torch.from_numpy(do),
                          causal, scale)  # CPU tensors: the plain version
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=ATTN_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax_interpret(causal):
    """Gradients of a weighted sum of the output through the port's
    flash_attention (the CPU path: mha_reference under autograd) and
    through the kernels' custom op (its plain forward and backward on
    the CPU) against ``jax.grad`` of the JAX flash attention with the
    Pallas kernels in interpret mode."""
    b, s, hq, hkv, d = 1, 128, 8, 4, 64
    q, k, v, w = _normal(1, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                         (b, s, hq, d))

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, block_q=64,
                                    block_k=64, interpret=True)
        return (out * jnp.asarray(w)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    scale = 1.0 / math.sqrt(d)
    for attend in (
            lambda q, k, v: tattn.flash_attention(q, k, v, causal=causal),
            lambda q, k, v: tattn.flash_attention_kernel(q, k, v, causal, scale)):
        leaves = [x.requires_grad_() for x in _t(q, k, v)]
        (attend(*leaves) * torch.from_numpy(w)).sum().backward()
        for name, x, ref in zip(("dq", "dk", "dv"), leaves, want):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                                       atol=ATTN_ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# the training forward, remat and the loss
# ---------------------------------------------------------------------------


def _jax_tiny(remat: bool, policy: str):
    return JaxConfig.tiny(dtype=jnp.float32, remat=remat, remat_policy=policy,
                          max_seq_len=64)


def _port_tiny(jcfg) -> LlamaConfig:
    return LlamaConfig.tiny(dtype=torch.float32, remat=jcfg.remat,
                            remat_policy=jcfg.remat_policy,
                            max_seq_len=jcfg.max_seq_len)


def _batch(seed, b=2, s=16, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def tiny_params():
    """One flax init of the tiny model (scanned layout), as numpy."""
    model = JaxLlama(_jax_tiny(False, "nothing_saveable"))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, nn.unbox(params["params"]))


@pytest.mark.parametrize("remat,policy", [
    (False, "nothing_saveable"), (True, "nothing_saveable"), (True, "flash")])
def test_tiny_llama_loss_and_grads_match_jax(tiny_params, remat, policy):
    """The llama_train loss (fused CE, z-loss 1e-4) and the gradient of
    every parameter against ``jax.value_and_grad`` of the flax model
    with the same remat policy."""
    jcfg = _jax_tiny(remat, policy)
    jmodel = JaxLlama(jcfg)
    ids = _batch(0)

    def jloss(params):
        hidden = jmodel.apply({"params": params}, jnp.asarray(ids),
                              return_hidden=True)
        return jax_fused_ce(hidden[:, :-1], params["lm_head"]["kernel"],
                            jnp.asarray(ids)[:, 1:], z_loss=1e-4)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(tiny_params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want_grads))
    model = LlamaForCausalLM(_port_tiny(jcfg), device="cpu")
    model.load_params(params_from_jax(tiny_params))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    loss = llama_train.lm_loss(model, torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=name)


def test_tiny_llama_unfused_logits_match_jax(tiny_params):
    """The training forward's f32 logits (no fused CE) against flax's."""
    jcfg = _jax_tiny(False, "nothing_saveable")
    ids = _batch(1)
    want = JaxLlama(jcfg).apply({"params": tiny_params}, jnp.asarray(ids))
    model = LlamaForCausalLM(_port_tiny(jcfg), device="cpu")
    model.load_params(params_from_jax(tiny_params))
    got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("policy,forwards", [
    ("nothing_saveable", 6), ("dots", 6), ("flash", 3), ("flash_qkv", 3)])
def test_remat_policies_and_the_flash_op(monkeypatch, policy, forwards):
    """With attention routed through the kernels' custom op (its plain
    versions on the CPU), the ``flash`` policies save the op's out and
    lse: the attention forward runs once per layer per step instead of
    twice; every policy gives the gradients of no remat."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tattn.flash_fwd, tattn.flash_bwd

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(tattn, "flash_fwd", count_fwd)
    monkeypatch.setattr(tattn, "flash_bwd", count_bwd)
    monkeypatch.setattr(
        tllama, "flash_attention",
        lambda q, k, v, causal=True, scale=None, segment_ids=None:
        tattn.flash_attention_kernel(q, k, v, causal, q.shape[-1] ** -0.5))
    ids = torch.from_numpy(_batch(2, s=12))
    grads = {}
    for remat in (False, True):
        cfg = LlamaConfig.tiny(num_layers=3, dtype=torch.float32, remat=remat,
                               remat_policy=policy)
        model = LlamaForCausalLM(cfg, device="cpu")
        torch.manual_seed(0)
        model.load_params({n: torch.randn_like(p) * 0.05
                           for n, p in model.named_parameters()})
        calls.update(fwd=0, bwd=0)
        llama_train.lm_loss(model, ids).backward()
        assert calls == {"fwd": forwards if remat else 3, "bwd": 3}, calls
        grads[remat] = torch.cat([p.grad.flatten() for p in model.parameters()])
    torch.testing.assert_close(grads[True], grads[False], rtol=0, atol=0)


def test_remat_policy_unknown_name_raises():
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        LlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy="bogus"),
                         device="cpu")


def test_training_config_defaults_and_param_dtypes():
    assert LlamaConfig.tiny().remat is False and LlamaConfig().remat is True
    assert LlamaConfig().decode is False
    train = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    serve = LlamaForCausalLM(LlamaConfig.tiny(decode=True), device="cpu")
    assert train.layers[0].attn.q_proj.dtype == torch.float32
    assert train.embed_tokens.requires_grad
    assert serve.layers[0].attn.q_proj.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve.parameters())
    assert serve.lm_head.dtype == train.lm_head.dtype == torch.float32
    with pytest.raises(ValueError, match="decode=True"):
        train(torch.zeros(1, 4, dtype=torch.long), cache=serve.new_cache(1))
    # init_params' f32 tensors are adopted as they are: no cast, no copy
    params = init_params(train.config, seed=0, device="cpu")
    train.load_params(params)
    for name, p in train.named_parameters():
        assert p.data_ptr() == params[name].data_ptr(), name


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------


def test_adamw_three_steps_match_optax():
    """torch AdamW as the port configures it against optax.adamw(lr,
    weight_decay=0.1) on the same parameters and gradient sequence."""
    lr = 1e-2
    p0 = _normal(4, (5, 3), (7,))
    grads = [_normal(10 + i, (5, 3), (7,)) for i in range(3)]
    tx = optax.adamw(lr, weight_decay=0.1)
    jp = [jnp.asarray(x) for x in p0]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(x) for x in _t(*[a.copy() for a in p0])]
    opt = adamw(tp, lr, weight_decay=0.1)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)


def _tiny_state(lr=1e-2):
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    torch.manual_seed(0)
    model.load_params({n: torch.randn_like(p) * 0.05
                       for n, p in model.named_parameters()})
    return create_train_state(model, lr)


def _loss_fn(state, b):
    return llama_train.lm_loss(state.model, b["input_ids"]), {
        "tokens": torch.tensor(float(b["input_ids"].numel()))}


def test_accum_steps_matches_the_full_batch():
    """One step over 2 microbatches of 2 equals one step over the batch
    of 4: the same loss (the mean of the microbatch means), the same
    mean gradient handed to the optimizer (left in ``.grad``), the same
    updated parameters, and averaged aux metrics."""
    batch = {"input_ids": torch.from_numpy(_batch(5, b=4, s=12))}
    full, accum = _tiny_state(), _tiny_state()
    _, m_full = make_train_step(_loss_fn)(full, batch)
    state, m_acc = make_train_step(_loss_fn, accum_steps=2)(accum, batch)
    assert state is accum and accum.step == 1
    np.testing.assert_allclose(m_acc["loss"].item(), m_full["loss"].item(),
                               rtol=1e-6)
    assert m_acc["tokens"].item() == 24.0 and m_full["tokens"].item() == 48.0
    for (name, a), b in zip(accum.model.named_parameters(), full.params()):
        want = b.grad.numpy()
        np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
        # Adam turns each entry's update into ~lr x its sign: rounding in a
        # near-zero gradient entry moves it by up to lr
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-2, err_msg=name)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        make_train_step(_loss_fn, accum_steps=3)(accum, batch)


def test_health_block_values_and_nan_poison():
    state = _tiny_state()
    batch = {"input_ids": torch.from_numpy(_batch(6, s=12))}
    before = [p.detach().clone() for p in state.params()]
    state, m = make_train_step(_loss_fn, health=True)(state, batch)
    grads = [p.grad for p in state.params()]
    want_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    upd = torch.sqrt(sum(((p.detach() - b) ** 2).sum()
                         for p, b in zip(state.params(), before)))
    ref = torch.sqrt(sum((b ** 2).sum() for b in before))
    np.testing.assert_allclose(m["grad_norm"].item(), want_norm.item(), rtol=1e-5)
    np.testing.assert_allclose(m["update_ratio"].item(), (upd / ref).item(),
                               rtol=1e-4)
    assert m["nonfinite_grads"].item() == 0.0

    def poisoned(state, b):
        loss, aux = _loss_fn(state, b)
        return loss * torch.tensor(float("nan")), aux

    _, m = make_train_step(poisoned, health=True)(state, batch)
    assert m["nonfinite_grads"].item() > 0
    assert math.isnan(m["grad_norm"].item())


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def _run(args, capsys):
    out = llama_train.main(types.SimpleNamespace(
        process_id=0, program_args=args))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return out, lines


def test_llama_train_program_converges_on_cpu(capsys):
    out, lines = _run("--device=cpu --data=learnable --steps=20 "
                      "--batch_size=8 --seq_len=32 --lr=3e-3 --log_every=5 "
                      "--require_convergence=0.99", capsys)
    events = {ln.get("event") for ln in lines}
    assert {"mesh", "step_health", "convergence"} <= events
    mesh = next(ln for ln in lines if ln.get("event") == "mesh")
    assert mesh["dp"] == 1 and mesh["shape"]["fsdp"] == 1
    # the default strategy is fsdp, as in the JAX program
    steps = [ln["step"] for ln in lines if ln.get("run") == "llama-tiny-fsdp"]
    assert steps == [5, 10, 15, 20]
    conv = next(ln for ln in lines if ln.get("event") == "convergence")
    assert conv["ratio"] < 1.0 and out["ratio"] < 1.0
    assert isinstance(out["state"], TrainState) and out["state"].step == 20
    assert out["config"].num_heads == 8 and out["config"].head_dim == 16


@pytest.mark.parametrize("args,match", [
    ("--strategy=fsdp_tp_sp", "A7"),
    ("--strategy=pp", "A8"), ("--latency_hiding=1", "latency_hiding"),
    ("--num_experts=4", "num_experts"), ("--quant=int8", "quant")])
def test_llama_train_unported_options_raise(args, match, capsys):
    rdzv = types.SimpleNamespace(
        process_id=0, program_args=f"--device=cpu --steps=1 {args}")
    if match == "A7":
        # sequence parallelism is ported: the strategy runs (it raised
        # until it was); at world 1 its seq axis has one rank, so the
        # model attends with flash, as the JAX program's does
        out = llama_train.main(rdzv)
        mesh = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith('{"event": "mesh"'))
        assert mesh["shape"]["seq"] == 1 and out["state"].model.seq.size == 1
        assert out["config"].attention == "flash"
        return
    with pytest.raises(NotImplementedError, match=match):
        llama_train.main(rdzv)


@pytest.mark.parametrize("strategy", ["fsdp_tp", "fsdp"])
def test_llama_train_zero_on_several_slices_raises(strategy):
    """ZeRO on an HSDP mesh (several slices) runs under fsdp and fsdp_tp
    now: nothing refuses it before the mesh. One process cannot hold a
    2-slice mesh, so the run stops at the mesh's own size check
    (tests/test_torch_zero_hsdp.py runs it across 4 gloo ranks)."""
    extra = {"strategy": strategy, "zero_stage": "1"}
    assert llama_train._check_unported(extra) == strategy
    assert llama_train.mesh_config_for(strategy, 4, 2).data == 2
    with pytest.raises(ValueError, match="devices"):
        llama_train.main(types.SimpleNamespace(
            process_id=0, num_slices=2,
            program_args=f"--device=cpu --steps=1 --strategy={strategy} "
                         "--zero_stage=1"))


def test_llama_train_checkpoint_dir_saves_and_resumes(tmp_path, monkeypatch,
                                                      capsys):
    """--checkpoint_dir (the plain persistent manager, DCP): a run saves
    every --checkpoint_every steps; a restart restores the newest step
    bit-equal (the restored state IS the saved one: the restart asked
    for no further step) and then trains on from it."""
    for key in ("KTPU_CKPT_LOCAL_DIR", "KTPU_CKPT_DIR", "KTPU_PREEMPT_REQUESTED"):
        monkeypatch.delenv(key, raising=False)
    # set, so that the test's end unsets what mark_preempt_aware sets
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    base = (f"--device=cpu --model=tiny --batch_size=2 --seq_len=16 "
            f"--log_every=2 --checkpoint_dir={tmp_path} --checkpoint_every=2")

    def run(steps):
        out = llama_train.main(types.SimpleNamespace(
            process_id=0, program_args=f"{base} --steps={steps}"))
        events = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                  if line.startswith('{"event"')]
        return out, events

    first, events = run(4)
    assert not [e for e in events if e["event"] == "restored"]
    assert sorted(int(d.name) for d in tmp_path.iterdir() if d.name.isdigit()) == [2, 4]
    saved = {k: v.clone() for k, v in
             state_tree(first["state"]).items()}
    again, events = run(4)
    assert [e for e in events if e["event"] == "restored"] == [
        {"event": "restored", "step": 4}]
    assert again["restored_step"] == 4 and again["state"].step == 4
    restored = state_tree(again["state"])
    assert set(restored) == set(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    on, events = run(6)
    assert on["state"].step == 6
    assert [e["step"] for e in events if e["event"] == "step_phases"] == [6]


def test_llama_train_model_config_layers_and_remat():
    cfg = llama_train.model_config("llama3-8b", {"layers": "8",
                                                 "remat_policy": "flash"})
    assert (cfg.num_layers, cfg.hidden_size, cfg.vocab_size) == (8, 4096, 128256)
    assert cfg.remat and cfg.remat_policy == "flash" and not cfg.decode
    tiny = llama_train.model_config("tiny", {})
    assert (tiny.num_layers, tiny.remat) == (2, False)
    assert dataclasses.replace(tiny, remat=True).remat_policy == "nothing_saveable"
