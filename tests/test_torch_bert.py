"""The port's BERT (k8s_tpu_torch/models/bert.py) and
``programs.bert_train`` held to the JAX package on the CPU.

- ``BertForPretraining`` against flax's on the same numpy batch and
  weights (``bert_params_from_jax``; random from numpy in flax's tree,
  every bias and LayerNorm live, :func:`_random_params`):
  ``BertConfig.tiny(num_heads=2)`` (head dim 64, the kernels' regime on
  the card), B 2, S 64, token types; in f32 and in the default bf16;
  without a padding mask, and with one (row 0 has 40 real tokens) beside
  ``fused_qkv``, ``hf_head`` and ``bf16_norms``; both ``return_hidden``
  forms (MLM logits or the hidden states, and the NSP logits). Limits:
  f32 2e-5 absolute (observed 7e-7: the same f32 sums in another
  order); bf16 2e-2 of the largest value, at least 1 (observed up to
  5e-3 of logits of ~1.3: both sides round every projection, GELU and
  embedding to bf16, at other points).
- One ``bert_train`` step (``--tiny=1 --batch_size=4``): the JAX program
  runs up to its first step with its mesh, state and step builders
  stubbed, which hands over its batch, its model and its ``loss_fn``;
  the port's batch must equal it, and the port's loss and every gradient
  must match ``jax.grad`` of that ``loss_fn`` on the same weights, for
  all three loss paths (gathered masked positions through the fused CE,
  ``--full_head=1``, ``--fused_ce=0``). In f32 (the program's config
  with dtype f32): loss 1e-5 relative, each gradient within 1e-4 of its
  L2 norm plus 1e-6 of the largest gradient's (the k-projection bias's
  gradient is zero in exact math — softmax ignores a score shift shared
  by every key — so both sides' values are ~1e-11 of noise). In the
  program's bf16 (default path): loss 1e-3 relative, each gradient
  within three times flax's own bf16 error against its f32 gradient
  plus 1e-2 of its norm (the same floor), as tests/test_torch_resnet.py
  holds bf16 gradients.
- The program's optimizer (AdamW 1e-4 with weight decay 1e-4) fed flax's
  gradient against ``optax.adamw(1e-4)``: rtol 1e-5, atol 1e-7 (see
  tests/test_torch_mnist.py for why the same gradient feeds both).
- ``tp_layout`` against the JAX program's for 1..8 ranks; the port's
  ``main`` in process (a one-rank ``TP`` table laid out as ``dp``, the
  losses logged and falling on the fixed batch); the operator admits the
  program (``check_program_ported``); and the refusals: int8 matmuls
  (ROADMAP A10) and a tensor axis above one rank (ROADMAP A16).
"""

import contextlib
import dataclasses
import functools
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import k8s_tpu.programs.bert_train as jbt
from k8s_tpu.models import BertConfig as JaxBertConfig
from k8s_tpu.models import BertForPretraining as JaxBert
from k8s_tpu_torch.models import BertConfig, BertForPretraining, bert_params_from_jax
from k8s_tpu_torch.parallel import LogicalRules
from k8s_tpu_torch.programs import bert_train as tbt
from k8s_tpu_torch.train import adamw
from k8s_tpu_torch.train import create_sharded_state
from k8s_tpu_torch.trainer.replicas import check_program_ported

torch.set_num_threads(2)

F32_ATOL = 2e-5
BF16_REL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {"plain": {}, "mask_fused_qkv": {"fused_qkv": True},
            "mask_hf_head": {"hf_head": True}, "mask_bf16_norms": {"bf16_norms": True}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(model, *args, seed=1):
    """Random weights in the flax model's parameter tree: the tree from
    ``jax.eval_shape`` of its init (no compile, so no per-config init
    cost), each leaf drawn from ``np.random.default_rng(seed)``: kernels
    and embeddings 0.05 x normal, biases 0.02 x normal, LayerNorm scales
    1 + 0.05 x normal (every bias and norm live)."""
    import flax.linen as nn

    shapes = nn.meta.unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), *args)["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return jnp.asarray(1.0 + 0.05 * x)
        return jnp.asarray((0.02 if name == "bias" else 0.05) * x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _weights(variant):
    """Random f32 weights of the variant (the same for both dtypes) and
    the model's inputs."""
    rng = np.random.default_rng(0)
    b, s = 2, 64
    ids = rng.integers(0, 512, (b, s)).astype(np.int32)
    types_ = rng.integers(0, 2, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, 40:] = 0
    cfg = JaxBertConfig.tiny(num_heads=2, **VARIANTS[variant])
    params = _random_params(JaxBert(cfg), jnp.asarray(ids), jnp.asarray(types_))
    return params, ids, types_, mask


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_flax(variant, dtype):
    params, ids, types_, mask = _weights(variant)
    jdt, tdt = DTYPES[dtype]
    jm = JaxBert(JaxBertConfig.tiny(num_heads=2, dtype=jdt, **VARIANTS[variant]))
    tm = BertForPretraining(BertConfig.tiny(num_heads=2, dtype=tdt, **VARIANTS[variant]),
                            device="cpu")
    tm.load_params(bert_params_from_jax(_np(params)))
    attn_mask = None if variant == "plain" else mask
    apply = functools.partial(jm.apply, return_hidden=False)
    apply_h = functools.partial(jm.apply, return_hidden=True)
    jargs = (jnp.asarray(ids), jnp.asarray(types_),
             None if attn_mask is None else jnp.asarray(attn_mask))
    targs = (torch.from_numpy(ids), torch.from_numpy(types_),
             None if attn_mask is None else torch.from_numpy(attn_mask))
    with torch.no_grad():
        for jfn, hidden in ((apply, False), (apply_h, True)):
            jout = jfn({"params": params}, *jargs)
            tout = tm(*targs, return_hidden=hidden)
            for name, j, t in zip(("hidden" if hidden else "mlm", "nsp"), jout, tout):
                j = np.asarray(j.astype(jnp.float32))
                t = t.float().numpy()
                assert j.shape == t.shape, name
                # the hidden states leave the last LayerNorm in f32, as
                # flax's do (bf16 only with bf16_norms)
                if hidden and name == "hidden":
                    want = torch.bfloat16 if (dtype == "bf16" and variant == "mask_bf16_norms") \
                        else torch.float32
                    assert tout[0].dtype == want
                err = np.abs(j - t).max()
                lim = F32_ATOL if dtype == "f32" else BF16_REL * max(1.0, np.abs(j).max())
                assert err <= lim, (name, err, lim)


class _Captured(Exception):
    pass


@functools.lru_cache(maxsize=None)
def _jax_program(args):
    """The JAX program's batch, model and loss_fn for ``--tiny=1
    --batch_size=4 <args>``: its main run until its first step, with the
    mesh (None), the state and the step builder stubbed."""
    got = {}

    def fake_state(model, tx, mesh, rules, rng, ids):
        got["model"] = model
        got["ids"] = ids
        return types.SimpleNamespace(step=0, apply_fn=model.apply)

    def fake_step(loss_fn, mesh, rules):
        got["loss_fn"] = loss_fn

        def run(state, batch, rng):
            got["batch"] = batch
            raise _Captured()
        return run

    rdzv = types.SimpleNamespace(program_args="--tiny=1 --batch_size=4 " + args,
                                 process_id=0, num_processes=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jbt, "create_sharded_state", fake_state)
    mp.setattr(jbt, "make_train_step", fake_step)
    mp.setattr(jbt, "build_mesh", lambda cfg: None)
    try:
        with pytest.raises(_Captured):
            jbt.main(rdzv)
    finally:
        mp.undo()
    got["params"] = _random_params(got["model"], got["ids"])
    return got


@functools.lru_cache(maxsize=None)
def _jax_grads(args, dtype):
    """Loss and gradients (the port's names) of the JAX program's
    ``loss_fn`` for ``args`` under ``jax.grad``, its model in ``dtype``."""
    got = _jax_program(args)
    model = JaxBert(dataclasses.replace(got["model"].config, dtype=dtype))
    state = types.SimpleNamespace(apply_fn=model.apply)
    fn = jax.jit(jax.value_and_grad(
        lambda p: got["loss_fn"](state, p, got["batch"], None)[0]))
    loss, grads = fn(got["params"])
    return float(loss), bert_params_from_jax(_np(grads))


def _port_step(got, fused_ce, full_head, dtype):
    """The port's loss and gradients of one step on the JAX weights."""
    tm = BertForPretraining(BertConfig.tiny(dtype=dtype), device="cpu")
    tm.load_params(bert_params_from_jax(_np(got["params"])))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in got["batch"].items()}
    loss, _ = tbt.make_loss_fn(fused_ce, full_head)(types.SimpleNamespace(model=tm),
                                                    batch)
    loss.backward()
    return loss.item(), {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in tm.named_parameters()}


def _grad_errs(grads, ref):
    """Per leaf of ``ref``: ||g - ref|| and ||ref||, and the largest norm."""
    top = max(r.norm().item() for r in ref.values())
    return {n: ((grads[n] - r).norm().item(), r.norm().item()) for n, r in ref.items()}, top


LOSS_PATHS = {"masked_positions": ("", True, False),
              "full_head": ("--full_head=1", True, True),
              "unfused": ("--fused_ce=0", False, False)}


@pytest.mark.parametrize("path", sorted(LOSS_PATHS))
def test_train_step_matches_jax_program_f32(path):
    args, fused_ce, full_head = LOSS_PATHS[path]
    got = _jax_program(args)
    batch = tbt.synthetic_batch(4, 64, 512)
    assert set(batch) == set(got["batch"])
    for k, v in batch.items():
        np.testing.assert_array_equal(v, np.asarray(got["batch"][k]), err_msg=k)
    jloss, jgrads = _jax_grads(args, jnp.float32)
    loss, grads = _port_step(got, fused_ce, full_head, torch.float32)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert "type_embed" not in jgrads  # the JAX program feeds no token types
    errs, top = _grad_errs(grads, jgrads)
    for name, (err, norm) in errs.items():
        assert err <= 1e-4 * norm + 1e-6 * top, (name, err, norm)


def test_train_step_matches_jax_program_bf16():
    """The program's own dtype, default loss path, against flax's bf16
    gradients within three times flax's own bf16 error."""
    got = _jax_program("")
    jloss, jgrads = _jax_grads("", jnp.bfloat16)
    _, jgrads32 = _jax_grads("", jnp.float32)
    loss, grads = _port_step(got, True, False, torch.bfloat16)
    assert abs(loss - jloss) <= 1e-3 * abs(jloss)
    errs, top = _grad_errs(grads, jgrads)
    own, _ = _grad_errs(jgrads, jgrads32)
    for name, (err, norm) in errs.items():
        limit = 3 * own[name][0] + 1e-2 * norm + 1e-6 * top
        assert err <= limit, (name, err, own[name][0], norm)


def test_optimizer_matches_optax_adamw():
    got = _jax_program("")
    _, jgrads = _jax_grads("", jnp.float32)
    params = bert_params_from_jax(_np(got["params"]))
    # the update is per leaf: one of each kind (embedding, kernels,
    # biases, LayerNorm) keeps optax's compile short
    names = ["layers.0.ln_attn.scale", "layers.0.q_proj.bias",
             "layers.0.q_proj.kernel", "layers.1.fc_out.kernel",
             "mlm_head.bias", "mlm_head.kernel", "tok_embed"]
    tparams = [torch.nn.Parameter(params[n].clone()) for n in names]
    opt = adamw(tparams, lr=tbt.LR, weight_decay=tbt.WEIGHT_DECAY)
    for p, n in zip(tparams, names):
        p.grad = jgrads[n].clone()
    opt.step()
    tx = optax.adamw(1e-4)
    jp = {n: jnp.asarray(params[n].numpy()) for n in names}
    jg = {n: jnp.asarray(jgrads[n].numpy()) for n in names}
    want = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        jg, jp)
    for p, n in zip(tparams, names):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_tp_layout_matches_jax_program():
    for tiny, cap in ((True, 4), (False, 8)):
        jcfg = JaxBertConfig.tiny() if tiny else JaxBertConfig.base()
        tcfg = BertConfig.tiny() if tiny else BertConfig.base()
        for n in range(1, 9):
            jt, jd, jr = jbt.tp_layout(n, jcfg, cap=cap)
            tt, td, tr = tbt.tp_layout(n, tcfg, cap=cap)
            assert (tt, td) == (jt, jd) and tr._rules == jr._rules, (tiny, n)


def test_main_trains_tiny_on_cpu():
    """The port's program in process: a one-rank TP table laid out as
    dp, AdamW at the JAX program's settings, the losses logged and
    falling on the fixed batch."""
    rdzv = types.SimpleNamespace(
        program_args="--tiny=1 --batch_size=4 --steps=3 --log_every=1 --device=cpu",
        process_id=0, num_processes=1, device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tbt.main(rdzv)
    logged = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert [e["step"] for e in logged if e.get("run") == "bert"] == [1, 2, 3]
    losses = [loss for _, loss in res["losses"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert res["state"].layout.strategy == "dp"
    group = res["state"].optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (1e-4, 1e-4)


def test_operator_admits_bert_train():
    check_program_ported("k8s_tpu_torch.programs.bert_train:main")


def test_refusals_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        BertForPretraining(BertConfig.tiny(quant="int8"), device="cpu")
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "stage", "fsdp", "expert", "seq", "tensor"),
        mesh=np.zeros((1, 1, 1, 1, 1, 2)))
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        BertForPretraining(BertConfig.tiny(mesh=mesh), device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        create_sharded_state(BertForPretraining(BertConfig.tiny(), device="cpu"),
                             1e-4, mesh, LogicalRules(LogicalRules.TP))
