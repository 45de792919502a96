"""The port's ring and Ulysses attention
(``move2kube_tpu_torch/parallel/ring_attention.py`` and ``ulysses.py``) in
gloo worlds of 4 and 2 processes on the CPU, against the JAX package's
``ring_attention_sharded`` and ``ulysses_attention_sharded`` on
``MeshConfig(data=2, seq=4)`` and ``(data=1, seq=2)`` of the 8 forced
host devices (``tests/test_models.py``'s way of running them), fed the
same numpy inputs: the output, and the gradients of a fixed linear
function of it (``sum(o * w)``; ``jax.grad`` on the JAX side, the
autograd backward on the port's), in fp32 to 1e-5, the reference test's
``atol``.

Rank r of a world holds tokens ``[r S, (r+1) S)`` of every row; the JAX
side shards the rows over ``data`` too, which changes no row's result.
GQA: the port takes K/V at 2 heads for 4 query heads, where the JAX
model repeats them up to 4 before attention (so the JAX function runs
on the repeated K/V, and ``jax.grad`` sums their gradients back): at
``seq`` 2 Ulysses exchanges K/V at their own head count, at ``seq`` 4
(which 2 heads do not divide) it repeats them first, as the reference
does. Ulysses' ``ValueError`` on 4 heads over 8 ranks, naming
``ring_attention``, is checked on both sides (the port's in a fake
process group of 8 inside a rank process). The ring's K/V hop moves K/V
at their own head count, by ``RING_STATS``' ``sp_bytes``.

One world a size runs every case while the references compile here,
one compile a case. Serving: a tiny Llama built with ``attn_impl="ring"``
(or ``"ulysses"``) serves on one device, with no seq group, and its
greedy streams are the flash config's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread
import torch._dynamo  # noqa: E402,F401 - sets its env var before any test

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention_sharded,
)
from move2kube_tpu.parallel.ulysses import (  # noqa: E402
    ulysses_attention_sharded,
)
from tests.test_torch_ring import (  # noqa: E402,F401
    World,
    _process_state_unchanged,
)

ATOL = 1e-5
B, S, H, D = 2, 32, 4, 16

WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, n, store, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
from move2kube_tpu_torch.parallel import overlap
from move2kube_tpu_torch.parallel.ring_attention import ring_attention
from move2kube_tpu_torch.parallel.ulysses import ulysses_attention

out = {}
try:
    spec = json.load(open(spec_path))
    data = np.load(spec["inputs"])
    for case in spec["cases"]:
        name, impl, causal = case["name"], case["impl"], case["causal"]
        size = data[name + "/q"].shape[1] // n
        cut = slice(rank * size, (rank + 1) * size)
        q, k, v, w = (torch.from_numpy(np.ascontiguousarray(
            data[f"{name}/{x}"][:, cut])) for x in "qkvw")
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        overlap.reset_ring_stats()
        o = fn(q, k, v, dist.group.WORLD, causal=causal)
        out[name + "/fwd_bytes"] = np.asarray(overlap.RING_STATS["sp_bytes"])
        (o * w).sum().backward()
        out[name + "/o"] = o.detach().numpy()
        for x, t in zip("qkv", (q, k, v)):
            out[f"{name}/d{x}"] = t.grad.numpy()
finally:
    dist.destroy_process_group()
if rank == 0 and spec.get("refusal"):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        t = torch.zeros(1, 4, 4, 8)
        ulysses_attention(t, t, t, dist.group.WORLD)
    except ValueError as e:
        out["refusal"] = np.asarray(str(e))
    finally:
        dist.destroy_process_group()
np.savez(out_path, **out)
'''

# (impl, seq extent, kv heads, causal)
CASES = [(impl, n, kvh, True) for n in (4, 2) for impl in ("ring", "ulysses")
         for kvh in (4, 2)] + [(impl, 4, 4, False)
                               for impl in ("ring", "ulysses")]


def _name(impl, n, kvh, causal) -> str:
    return f"{impl}-seq{n}-kv{kvh}" + ("" if causal else "-full")


def _inputs(case) -> dict:
    impl, n, kvh, causal = case
    rng = np.random.default_rng(CASES.index(case))
    return {"q": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, kvh, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, kvh, D)).astype(np.float32),
            "w": rng.normal(size=(B, S, H, D)).astype(np.float32)}


def _jax(case, x) -> dict:
    """The reference's sharded function on its mesh: output and the
    gradients of ``sum(o * w)``, K/V repeated up to the query heads
    first (the JAX model's GQA)."""
    impl, n, kvh, causal = case
    data = 2 if n == 4 else 1
    mesh = make_mesh(MeshConfig(data=data, seq=n),
                     devices=jax.devices()[:data * n])
    fn = ring_attention_sharded if impl == "ring" else \
        ulysses_attention_sharded
    rep = H // kvh

    def f(q, k, v):
        o = fn(mesh, q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
               causal=causal)
        return jnp.sum(o * x["w"]), o

    (_, o), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                               has_aux=True))(
        x["q"], x["k"], x["v"])
    return {"o": np.asarray(o), **{f"d{c}": np.asarray(g)
                                    for c, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def seq_attn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqattn")
    inputs = {c: _inputs(c) for c in CASES}
    worlds = {}
    try:
        for n in (4, 2):
            flat = {f"{_name(*c)}/{k}": v for c in CASES if c[1] == n
                    for k, v in inputs[c].items()}
            np.savez(tmp / f"seq{n}.npz", **flat)
            worlds[n] = World(tmp, f"seq{n}", n, {
                "inputs": str(tmp / f"seq{n}.npz"), "refusal": n == 2,
                "cases": [{"name": _name(*c), "impl": c[0], "causal": c[3]}
                          for c in CASES if c[1] == n]}, WORKER)
        want = {c: _jax(c, inputs[c]) for c in CASES}
        return {n: w.outputs() for n, w in worlds.items()}, want
    finally:
        for w in worlds.values():
            w.kill()


def _whole(got, key):
    """Every rank's shard put back in token order."""
    return np.concatenate([g[key] for g in got], axis=1)


@pytest.mark.parametrize("case", CASES, ids=[_name(*c) for c in CASES])
def test_seq_attention_matches_the_jax_reference(seq_attn, case):
    got, want = seq_attn
    name = _name(*case)
    for key in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(_whole(got[case[1]], f"{name}/{key}"),
                                   want[case][key], atol=ATOL, rtol=0,
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("n", [4, 2])
def test_ring_moves_kv_at_their_own_head_count(seq_attn, n):
    """The forward's n - 1 hops each carry this rank's K and V shards at
    2 heads (fp32), not repeated up to the 4 query heads."""
    got, _ = seq_attn
    size = S // n
    for r in range(n):
        moved = int(got[n][r][f"{_name('ring', n, 2, True)}/fwd_bytes"])
        assert moved == (n - 1) * 2 * B * size * 2 * D * 4, (r, moved)


def test_ulysses_refuses_heads_the_group_does_not_divide(seq_attn):
    """4 heads over 8 ranks: a ``ValueError`` naming ``ring_attention``
    on both sides."""
    got, _ = seq_attn
    msg = str(got[2][0]["refusal"])
    assert "ring_attention" in msg and "(4)" in msg and "(8)" in msg, msg
    mesh = make_mesh(MeshConfig(seq=8))
    x = jnp.zeros((1, 32, 4, 8))
    with pytest.raises(ValueError, match="ring_attention"):
        ulysses_attention_sharded(mesh, x, x, x)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_a_seq_config_serves_as_flash_on_one_device(impl):
    import dataclasses

    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.models.llama import llama_tiny
    from move2kube_tpu_torch.serving import engine as tengine

    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=n).tolist() for n in (5, 9, 14)]
    streams = {}
    for attn in (impl, "flash"):
        cfg = dataclasses.replace(llama_tiny(), dtype=torch.float32,
                                  attn_impl=attn)
        eng = tengine.ServingEngine(
            init_llama(cfg, seed=0, device="cpu"), tengine.EngineConfig(
                max_batch=4, max_seq=64, block_size=8, buckets=(16, 32)),
            device="cpu")
        streams[attn] = {c.rid: c.tokens for c in eng.run(
            [tengine.Request(f"r{i}", p, 8) for i, p in enumerate(prompts)])}
    assert streams[impl] == streams["flash"]
    assert all(len(t) == 8 for t in streams[impl].values())
