"""Ring and Ulysses attention of the port (k8s_tpu_torch/parallel/
ring_attention.py, ulysses.py) and the flash kernels' ring features
(``out_f32``, ``grads_f32``, ``segment_ids_kv``) held on the CPU against
the JAX package's per-device bodies.

The JAX side runs ``ring_flash_attention_sharded`` (its Pallas kernels in
interpret mode), ``ring_attention_sharded`` and
``ulysses_attention_sharded`` through ``shard_map_compat`` over the
conftest's forced CPU devices, forward and backward under one ``jit``
each (not the global ``ring_attention``/``ulysses_attention``: they read
flax's logical-axis rules, ``flax.linen.spmd._axis_rules``, which some
flax releases lack).

The port side runs every rank's body on one group of 4 gloo processes,
started once for the module: the seq axis of ``MeshConfig(seq=4)``
(degree 4) and of ``MeshConfig(data=2, seq=2)`` (degree 2), the einsum
body and the flash body (on CPU tensors the kernels' plain versions)
under autograd, causal and not, with packed ids whose boundary (100) is
not on a chunk edge; Ulysses at degree 2, and its error at degree 4 (2
kv heads). The flash body also runs over ``chip_smoke.py``'s thread
transport (4 threads, ``ring_flash_forward``/``ring_flash_backward``
called directly), as the card's ``ring`` phase runs it.

f32 inputs from a numpy seed, B 1, S 256, 4 q / 2 kv heads of 128: O
within 2e-5 absolute, dQ, dK and dV within 1e-4. The plain ``flash_fwd``
with ``segment_ids_kv`` and ``out_f32`` and ``flash_bwd`` with
``grads_f32`` against ``_flash_forward``/``_flash_backward`` (interpret
mode) on one ring step's blocks, at the same limits.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import chip_smoke
from k8s_tpu.ops.attention import _flash_backward, _flash_forward, compute_dd
from k8s_tpu.parallel.ring_attention import (
    ring_attention_sharded as jax_ring_einsum,
    ring_flash_attention_sharded as jax_ring_flash,
)
from k8s_tpu.parallel.ulysses import ulysses_attention_sharded as jax_ulysses
from k8s_tpu.utils import shard_map_compat
from k8s_tpu_torch.ops import attention as tattn
from k8s_tpu_torch.parallel import ring_attention as tring

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
B, S, HQ, HKV, D = 1, 256, 4, 2, 128
BOUNDARY = 100
SCALE = 1.0 / D ** 0.5
# (ring degree, causal, packed ids)
CASES = [(4, True, True), (4, False, False), (2, False, True), (2, True, False)]
ULYSSES = (2, True, True)


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.standard_normal((B, S, h, D)).astype(np.float32)
                   for h in (HQ, HKV, HKV, HQ))
    seg = np.where(np.arange(S) < BOUNDARY, 1, 2)[None].repeat(B, 0).astype(np.int32)
    return q, k, v, do, seg


CHILD = r"""
import json, sys
import numpy as np
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
from k8s_tpu_torch.parallel import MeshConfig, build_mesh
from k8s_tpu_torch.parallel.ring_attention import (ProcessGroupRing,
    ring_attention_sharded, ring_flash_attention_sharded)
from k8s_tpu_torch.parallel.ulysses import ulysses_attention_sharded

B, S, HQ, HKV, D = spec["shape"]
rng = np.random.RandomState(0)
q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(np.float32))
               for h in (HQ, HKV, HKV, HQ))
seg = torch.from_numpy(np.where(np.arange(S) < spec["boundary"], 1, 2)[None]
                       .repeat(B, 0).astype(np.int32))
rings = {4: ProcessGroupRing.of(build_mesh(MeshConfig(data=1, seq=4), "cpu")),
         2: ProcessGroupRing.of(build_mesh(MeshConfig(data=2, seq=2), "cpu"))}
out = {}

def run(fn, n, ring, causal, packed):
    c = S // n
    cut = lambda x: x[:, ring.rank * c:(ring.rank + 1) * c]
    ql, kl, vl = (cut(x).clone().requires_grad_() for x in (q, k, v))
    o = fn(ql, kl, vl, cut(seg) if packed else None, ring, causal)
    o.backward(cut(do))
    path = f"{spec['dir']}/{fn.__name__}_{n}_{causal}_{packed}_{ring.rank}_{rank}.npz"
    np.savez(path, o=o.detach().numpy(), dq=ql.grad.numpy(), dk=kl.grad.numpy(),
             dv=vl.grad.numpy())
    return path

def einsum(q, k, v, s, ring, causal):
    return ring_attention_sharded(q, k, v, s, ring, causal)

def flash(q, k, v, s, ring, causal):
    return ring_flash_attention_sharded(q, k, v, s, ring, causal)

def ulysses(q, k, v, s, ring, causal):
    return ulysses_attention_sharded(q, k, v, s, ring, causal)

for n, causal, packed in spec["cases"]:
    for fn in (einsum, flash):
        out[f"{fn.__name__}_{n}_{causal}_{packed}"] = [rings[n].rank,
            run(fn, n, rings[n], causal, packed)]
n, causal, packed = spec["ulysses"]
out["ulysses"] = [rings[n].rank, run(ulysses, n, rings[n], causal, packed)]
try:
    ulysses(q[:, :64], k[:, :64], v[:, :64], None, rings[4], True)
    out["ulysses_error"] = None
except ValueError as e:
    out["ulysses_error"] = str(e)
print(json.dumps({"rank": rank, "out": out}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_body(body, n, causal, packed, **kw):
    """The JAX per-device body over ``n`` forced CPU devices: (out, dq,
    dk, dv) of the whole sequence, under one jit."""
    q, k, v, do, seg = _inputs()
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq", None, None)
    seg_spec = (P(None, "seq"),) if packed else ()
    f = shard_map_compat(partial(body, axis_name="seq", causal=causal, scale=SCALE, **kw),
                         mesh=mesh, in_specs=(spec, spec, spec) + seg_spec,
                         out_specs=spec)

    @jax.jit
    def fwd_bwd(q, k, v, do, *seg):
        out, vjp = jax.vjp(lambda a, b, c: f(a, b, c, *seg), q, k, v)
        return (out, *vjp(do))

    return [np.asarray(x) for x in fwd_bwd(q, k, v, do, *((seg,) if packed else ()))]


@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    """The gang's outputs gathered into whole sequences (by body and
    case), its Ulysses error, and the JAX bodies' outputs; the JAX side
    is computed while the gang runs."""
    tmp = tmp_path_factory.mktemp("ring")
    spec = {"shape": [B, S, HQ, HKV, D], "boundary": BOUNDARY, "cases": CASES,
            "ulysses": ULYSSES, "dir": str(tmp)}
    env = {k: v for k, v in os.environ.items() if not k.startswith("KTPU_")}
    env["PYTHONPATH"] = str(REPO)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), "4", port, json.dumps(spec)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        jax_out = {("einsum",) + c: _jax_body(jax_ring_einsum, *c) for c in CASES}
        jax_out[("flash",) + CASES[0]] = _jax_body(jax_ring_flash, *CASES[0],
                                                   interpret=True)
        jax_out[("ulysses",) + ULYSSES] = _jax_body(jax_ulysses, *ULYSSES)
        ranks = []
        for p in procs:
            o, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            ranks.append(json.loads(o.strip().splitlines()[-1])["out"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    port_out = {}
    for key in ranks[0]:
        if key == "ulysses_error":
            continue
        n = ULYSSES[0] if key == "ulysses" else int(key.split("_")[1])
        whole = {}
        for part in ("o", "dq", "dk", "dv"):
            # each seq rank's chunk at its place (both degree-2 replicas
            # computed the same: the first of each chunk is taken)
            chunks = {}
            for seq_rank, path in (r[key] for r in ranks):
                chunks.setdefault(seq_rank, np.load(path)[part])
            whole[part] = np.concatenate([chunks[i] for i in range(n)], axis=1)
        port_out[key] = whole
    return {"port": port_out, "jax": jax_out,
            "errors": [r["ulysses_error"] for r in ranks]}


def _close(got, want, what):
    o, dq, dk, dv = want
    np.testing.assert_allclose(got["o"], o, rtol=0, atol=OUT_ATOL, err_msg=f"{what} out")
    for name, w in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[name], w, rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("body", ["einsum", "flash"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"n{c[0]}-causal{c[1]}-packed{c[2]}")
def test_ring_bodies_match_the_jax_einsum_body(ring_results, body, case):
    """Each port body's gathered O, dQ, dK and dV against the JAX einsum
    body (the same function) on the same inputs and degree."""
    _close(ring_results["port"][f"{body}_{case[0]}_{case[1]}_{case[2]}"],
           ring_results["jax"][("einsum",) + case], f"{body} {case}")


def test_flash_body_matches_the_jax_flash_body(ring_results):
    """The flash body against the JAX Pallas ring (interpret mode): degree
    4, causal, packed ids rotating with their KV chunks."""
    case = CASES[0]
    _close(ring_results["port"][f"flash_{case[0]}_{case[1]}_{case[2]}"],
           ring_results["jax"][("flash",) + case], f"flash {case}")


def test_ulysses_matches_the_jax_body(ring_results):
    _close(ring_results["port"]["ulysses"], ring_results["jax"][("ulysses",) + ULYSSES],
           "ulysses")


def test_ulysses_refuses_a_degree_that_does_not_divide_the_heads(ring_results):
    q, k, v = (jnp.zeros((1, 64, h, D)) for h in (HQ, HKV, HKV))
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    spec = P(None, "seq", None, None)
    f = shard_map_compat(partial(jax_ulysses, axis_name="seq"), mesh=mesh,
                         in_specs=(spec, spec, spec), out_specs=spec)
    with pytest.raises(ValueError) as jerr:
        f(q, k, v)
    assert ring_results["errors"] == [str(jerr.value)] * 4


def test_flash_body_over_the_chip_smoke_thread_ring(ring_results):
    """4 threads, one rank each, calling ``ring_flash_forward`` and
    ``ring_flash_backward`` over ``chip_smoke.ThreadRing`` (the card's
    ``ring`` phase), against the JAX Pallas ring."""
    q, k, v, do, seg = (torch.from_numpy(x) for x in _inputs())
    n = 4
    c = S // n

    def rank_body(ring):
        cut = lambda x: x[:, ring.rank * c:(ring.rank + 1) * c]  # noqa: E731
        out, lse = tring.ring_flash_forward(cut(q), cut(k), cut(v), cut(seg), ring,
                                            True, SCALE)
        grads = tring.ring_flash_backward(cut(q), cut(k), cut(v), cut(seg), out, lse,
                                          cut(do), ring, True, SCALE)
        return out, grads

    res = chip_smoke.run_thread_ring(n, rank_body, timeout=120)
    got = {"o": torch.cat([r[0] for r in res], 1).numpy()}
    for i, name in enumerate(("dq", "dk", "dv")):
        got[name] = torch.cat([r[1][i] for r in res], 1).numpy()
    _close(got, ring_results["jax"][("flash",) + CASES[0]], "thread ring")


def test_one_ring_step_of_the_plain_kernels_matches_pallas():
    """One ring step's blocks — queries of chunk 2 (ids all 2) over the
    resident KV chunk 1 (ids 1 then 2: the boundary falls inside it),
    non-causal — through the plain ``flash_fwd`` (``segment_ids_kv``,
    ``out_f32``) and ``flash_bwd`` (``grads_f32``) against the Pallas
    ``_flash_forward``/``_flash_backward`` in interpret mode with the
    same arguments."""
    q, k, v, do, seg = _inputs()
    c = 64
    qc, doc, segq = q[:, 2 * c:3 * c], do[:, 2 * c:3 * c], seg[:, 2 * c:3 * c]
    kc, vc, segk = k[:, c:2 * c], v[:, c:2 * c], seg[:, c:2 * c]
    assert set(segk[0]) == {1, 2} and set(segq[0]) == {2}
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    out, lse = tattn.flash_fwd(t(qc), t(kc), t(vc), False, SCALE, with_lse=True,
                               segment_ids=t(segq), segment_ids_kv=t(segk),
                               out_f32=True)
    grads = tattn.flash_bwd(t(qc), t(kc), t(vc), out, lse, t(doc), False, SCALE,
                            segment_ids=t(segq), segment_ids_kv=t(segk),
                            grads_f32=True)
    assert out.dtype == torch.float32 and all(g.dtype == torch.float32 for g in grads)
    j = [jnp.asarray(x) for x in (qc, kc, vc, doc)]
    jout, jlse = _flash_forward(*j[:3], False, SCALE, c, c, True, with_residuals=True,
                                out_f32=True, segment_ids=jnp.asarray(segq),
                                segment_ids_kv=jnp.asarray(segk))
    jgrads = _flash_backward(*j[:3], compute_dd(jout, j[3]), jlse, j[3], False, SCALE,
                             c, c, True, grads_f32=True, segment_ids=jnp.asarray(segq),
                             segment_ids_kv=jnp.asarray(segk))
    assert jout.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, HQ, c),
                               rtol=0, atol=OUT_ATOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=GRAD_ATOL)


def test_kv_segment_row_needs_the_query_row_and_equal_chunks():
    """``segment_ids_kv`` alone raises (the JAX ``_flash_forward``'s
    error), and the flash ring refuses unequal q/kv chunks as the JAX
    body does."""
    q, k, v, _, seg = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="segment_ids_kv requires segment_ids"):
        tattn.flash_fwd(q, k, v, False, SCALE, segment_ids_kv=seg)
    with pytest.raises(ValueError, match="segment_ids_kv requires segment_ids"):
        tattn.flash_bwd(q, k, v, q, torch.zeros(B, HQ, S), q, False, SCALE,
                        segment_ids_kv=seg)
    with pytest.raises(ValueError, match="equal q/kv chunk sizes"):
        tring.ring_flash_attention_sharded(q, k[:, :128], v[:, :128], ring=None)


def test_ring_attention_gate_runs_the_flash_body_on_the_cpu(monkeypatch):
    """The model's entry picks the flash body for equal chunks on CPU
    tensors (the kernels' plain versions: the body the card runs), and
    the einsum body for unequal chunks, which the kernels' ring cannot
    take."""
    q, k, v, _, seg = (torch.from_numpy(x) for x in _inputs())
    ring = tring.ProcessGroupRing(None, 1, 0)
    picked = []
    for name in ("ring_attention_sharded", "ring_flash_attention_sharded"):
        monkeypatch.setattr(tring, name, lambda *a, name=name: picked.append(name))
    tring.ring_attention(q, k, v, ring, segment_ids=seg)
    tring.ring_attention(q, k[:, :128], v[:, :128], ring)
    assert picked == ["ring_flash_attention_sharded", "ring_attention_sharded"]
