"""The port's mesh and layout rules (k8s_tpu_torch/parallel/mesh.py,
parallel/sharding.py, train/trainer_lib.py ``_resolve_zero_stage``) held
to the JAX package's functions on the CPU, and the fused-CE loss moved
into the model's forward held to the loss it replaced.

Everything here is exact: the functions pick axes and dimensions, so the
port must choose what the JAX function chooses, leaf by leaf, for every
parameter of the tiny and Llama-3-8B configs at DP 1, 2, 4 and 8. The
JAX ``zero1_partition_spec`` reads only ``dict(mesh.shape)``, so an
object with that attribute stands in for a mesh; ``zero3_param_shardings``
builds ``NamedSharding`` s, so it gets a real mesh of the conftest's
eight CPU devices.
"""

import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from k8s_tpu.models import LlamaConfig as JaxConfig
from k8s_tpu.models import LlamaForCausalLM as JaxLlama
from k8s_tpu.parallel import mesh as jmesh
from k8s_tpu.parallel import sharding as jsharding
from k8s_tpu.train import trainer_lib as jtrainer
from k8s_tpu_torch.models import LlamaConfig, LlamaForCausalLM, init_params
from k8s_tpu_torch.models.convert import param_shapes
from k8s_tpu_torch.parallel import mesh as tmesh
from k8s_tpu_torch.parallel import sharding as tsharding
from k8s_tpu_torch.programs import llama_train
from k8s_tpu_torch.train import trainer_lib as ttrainer

DPS = (1, 2, 4, 8)
CONFIGS = {"tiny": LlamaConfig.tiny(num_layers=2),
           "llama3-8b": LlamaConfig.llama3_8b(num_layers=2)}


@pytest.mark.parametrize("n,data,fsdp,tensor", [
    (8, -1, 1, 1), (8, -1, 2, 2), (8, 2, 4, 1), (4, 1, 4, 1), (6, -1, 3, 1),
    (8, 3, 1, 1), (5, -1, 2, 1)])
def test_mesh_config_resolved_and_shape(n, data, fsdp, tensor):
    jcfg = jmesh.MeshConfig(data=data, fsdp=fsdp, tensor=tensor)
    tcfg = tmesh.MeshConfig(data=data, fsdp=fsdp, tensor=tensor)
    try:
        want = jcfg.resolved(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcfg.resolved(n)
        assert str(got.value) == str(e)
        return
    got = tcfg.resolved(n)
    assert got.shape == want.shape and tcfg.shape == jcfg.shape


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 16, 48, 64])
@pytest.mark.parametrize("max_first", [1, 2, 4, 8, 32])
def test_best_pow2_split(n, max_first):
    assert tmesh.best_pow2_split(n, max_first) == jmesh.best_pow2_split(n, max_first)


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("stage", [None, 0, 1, 2, 3, 4, -1])
def test_resolve_zero_stage(zero1, stage):
    try:
        want = jtrainer._resolve_zero_stage(zero1, stage)
    except ValueError:
        with pytest.raises(ValueError, match="0..3"):
            ttrainer._resolve_zero_stage(zero1, stage)
        return
    assert ttrainer._resolve_zero_stage(zero1, stage) == want


def test_build_mesh_one_process_on_the_cpu():
    import torch.distributed as dist

    mesh = tmesh.build_mesh(tmesh.MeshConfig(), "cpu")
    assert dist.get_backend() == "gloo"
    assert tmesh.mesh_shape(mesh) == dict(zip(tmesh.AXES, (1,) * 6))
    assert tmesh.data_parallel_degree(mesh) == 1
    assert tmesh.AXES == jmesh.AXES


def _fake_mesh(**sizes):
    return types.SimpleNamespace(shape={a: sizes.get(a, 1) for a in jmesh.AXES})


def _placements(cfg, rules_name):
    trules = tsharding.LogicalRules(getattr(tsharding.LogicalRules, rules_name))
    return {n: tsharding.param_placement(n, trules)
            for n in param_shapes(cfg)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("rules,fsdp", [("DP", 1), ("FSDP", 2)])
def test_zero1_partition_spec_matches_jax(config, dp, rules, fsdp):
    cfg = CONFIGS[config]
    sizes = {"data": dp, "fsdp": fsdp}
    for name, shape in param_shapes(cfg).items():
        placement = _placements(cfg, rules)[name]
        want = jsharding.zero1_partition_spec(P(*placement), shape,
                                              _fake_mesh(**sizes))
        got = tsharding.zero1_partition_spec(placement, shape,
                                             {**{a: 1 for a in tmesh.AXES}, **sizes})
        assert (got is None) == (want is None), name
        if want is not None:
            assert got == tuple(want), name


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("leaves,min_size", [
    (("embed_tokens", "lm_head"), 0), ((), 1 << 16), (("q_proj",), 1 << 20)])
def test_zero3_selection_matches_jax(config, dp, leaves, min_size):
    cfg = CONFIGS[config]
    devices = np.array(jax.devices()[:dp]).reshape(dp, 1, 1, 1, 1, 1)
    mesh = Mesh(devices, jmesh.AXES)
    shapes = param_shapes(cfg)
    tree = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}
    want = jsharding.zero3_param_shardings(tree, mesh, min_leaf_size=min_size,
                                           leaves=list(leaves))
    sizes = {**{a: 1 for a in tmesh.AXES}, "data": dp}
    for name, shape in shapes.items():
        got = tsharding.zero3_selected(name, shape, (), sizes,
                                       min_leaf_size=min_size, leaves=leaves)
        w = want[name]
        assert (got is None) == (w is None), name
        if w is not None:
            assert got == tuple(w.spec), name


def _jax_port_dims(name):
    """For a JAX kernel, the port dimension each JAX dimension lands in
    (the port flattens ``[E, H, D]`` to ``[E, H*D]`` and ``o_proj``'s
    ``[H, D, E]`` to ``[H*D, E]``)."""
    if name.endswith("o_proj"):
        return (0, 0, 1)
    if name.endswith(("q_proj", "k_proj", "v_proj")):
        return (0, 1, 1)
    return None


def test_fsdp_placement_of_every_parameter_matches_the_jax_rules():
    jcfg = JaxConfig.tiny(dtype=jnp.float32, scan_layers=False, num_layers=2)
    model = JaxLlama(jcfg)
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 8), jnp.int32)))
    logical = nn.get_partition_spec(abstract)["params"]
    rules = jsharding.LogicalRules(jsharding.LogicalRules.FSDP).to_flax()

    def mesh_axes(spec):
        return tuple(nn.logical_to_mesh_axes(tuple(spec), rules))

    def port_dim(name, axes):
        dims = [i for i, a in enumerate(axes) if a == "fsdp"]
        if not dims:
            return None
        mapped = _jax_port_dims(name)
        return mapped[dims[0]] if mapped else dims[0]

    want = {"embed_tokens": port_dim("embed_tokens", mesh_axes(
                logical["embed_tokens"]["embedding"])),
            "lm_head": port_dim("lm_head", mesh_axes(logical["lm_head"]["kernel"])),
            "final_norm.weight": port_dim("", mesh_axes(
                logical["final_norm"]["weight"]))}
    for i in range(jcfg.num_layers):
        layer = logical[f"layer_{i}"]
        for sub, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                           ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for n in names:
                want[f"layers.{i}.{sub}.{n}"] = port_dim(
                    n, mesh_axes(layer[sub][n]["kernel"]))
        for n in ("input_norm", "post_attn_norm"):
            want[f"layers.{i}.{n}.weight"] = port_dim(
                n, mesh_axes(layer[n]["weight"]))
    trules = tsharding.LogicalRules(tsharding.LogicalRules.FSDP)
    port = LlamaForCausalLM(LlamaConfig.tiny(num_layers=2), device="cpu")
    got = {n: tsharding.shard_dim(tsharding.param_placement(n, trules), "fsdp")
           for n, _ in port.named_parameters()}
    assert got == want
    # every projection and lm_head shard dim 0, the table dim 1
    assert got["embed_tokens"] == 1 and got["lm_head"] == 0
    assert {got[f"layers.0.{n}"] for n in ("attn.o_proj", "mlp.down_proj")} == {0}


def test_dp_rules_place_nothing():
    trules = tsharding.LogicalRules(tsharding.LogicalRules.DP)
    for name in param_shapes(CONFIGS["tiny"]):
        assert set(tsharding.param_placement(name, trules)) == {None}
    assert trules["batch"] == jsharding.LogicalRules(
        jsharding.LogicalRules.DP)["batch"]


@pytest.mark.parametrize("shape,mesh_dims,placements", [
    ((8, 6), (2,), ("s0",)), ((7, 6), (2,), ("s0",)), ((3, 5), (4,), ("s0",)),
    ((8, 6), (2, 2), ("r", "s1")), ((8, 6), (2, 3), ("s0", "s1"))])
def test_shard_index_follows_torch_chunk(shape, mesh_dims, placements):
    from torch.distributed.tensor import Replicate, Shard

    places = [Replicate() if p == "r" else Shard(int(p[1])) for p in placements]
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    for coord in np.ndindex(*mesh_dims):
        want = x
        for size, p, c in zip(mesh_dims, places, coord):
            if isinstance(p, Shard):
                chunks = torch.chunk(want, size, dim=p.dim)
                want = chunks[c] if c < len(chunks) else want.narrow(p.dim, 0, 0)
        idx = tsharding.shard_index(shape, mesh_dims, places, coord)
        assert torch.equal(x[idx], want), (coord, idx)


def test_fused_ce_loss_in_forward_is_bit_equal_to_the_old_lm_loss():
    from k8s_tpu_torch.ops.fused_ce import fused_lm_head_cross_entropy

    cfg = LlamaConfig.tiny(num_layers=2)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_params(init_params(cfg, 3, "cpu", dtype=torch.float32))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 24)).astype(np.int64))
    hidden = model(ids, return_hidden=True)
    old = fused_lm_head_cross_entropy(hidden[:, :-1], model.lm_head, ids[:, 1:],
                                      z_loss=llama_train.Z_LOSS)
    old.backward()
    old_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    new = llama_train.lm_loss(model, ids)
    new.backward()
    assert torch.equal(new, old)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, old_grads[n]), n
