"""The port's tensor- and expert-parallel train steps (``models/llama.py``,
``models/gpt2.py``, ``models/moe.py`` split by ``parallel/sharding.py``'s
layouts over ``parallel/overlap.py``'s collectives) in gloo worlds on the
CPU, against the JAX package's one-device step on the same global batch.

Meshes: ``tensor=2``, ``fsdp=2 x tensor=2`` and ``data=2 x tensor=2``
(worlds of 2 and 4). Models: the tiny Llama (vocab 512 and 257: its
embedding and head split over tensor, and whole) and the tiny GPT-2 at
vocab 256 (its tied head split over tensor) and 257 (whole), each two SGD
steps from the flax init (``params_from_jax``), ``grad_accum`` 1 and 2.
The MoE Llama and the expert axis are ``tests/test_torch_ep.py``'s, on
this file's helpers (:func:`run_worlds` and the checks). The MoE runs at
a capacity factor of 0.5, so every step drops tokens (the test asserts
it on the global batch): the port routes the global batch's tokens
wherever the reference's step sees the global batch (its GSPMD step at
``grad_accum=1`` and its sequential scan, which every model-parallel
mesh takes), as the reference's ``models/train.py:492-540`` routes.

Tolerances (fp32):

- against the JAX step: the loss within 1e-5 relative, and each leaf's
  update within 1e-3 of the norm of the JAX update (the families' rule,
  ``tests/test_torch_moe.py``'s ``UPDATE_REL``): the port's row-split
  products sum over ranks in another order, and the vocab-parallel loss
  merges logsumexps by rank;
- across ranks, after every step: each rank's whole tree (its parts
  gathered) has the same bits, and each rank's parts are its slices of it
  (a fused projection's heads included);
- the last update's grad norm and health summaries against the port's
  own one-device step within 1e-6 relative (each part counted once).

Each world runs in spawned processes on a ``FileStore``, each rank
destroys its group, and the test's process holds no group.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread
import torch._dynamo  # noqa: E402,F401 - before any optimizer steps

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from move2kube_tpu.models import gpt2 as jgpt2  # noqa: E402
from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.models import moe as jmoe  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from tests.test_torch_ring import (  # noqa: E402,F401
    World,
    _process_state_unchanged,
)

LOSS_REL = 1e-5
UPDATE_REL = 1e-3
RECORD_REL = 1e-6
LR = 0.05
CHUNK = 128
CAPACITY_FACTOR = 0.5

MESHES = {"tensor2": {"tensor": 2}, "fsdp2xtensor2": {"fsdp": 2, "tensor": 2},
          "data2xtensor2": {"data": 2, "tensor": 2}}
# (mesh, family, vocab, grad_accum); the MoE's are tests/test_torch_ep.py's
CASES = [("tensor2", "llama", 512, 1), ("tensor2", "llama", 257, 1),
         ("tensor2", "gpt2", 256, 1), ("tensor2", "gpt2", 257, 1),
         ("fsdp2xtensor2", "llama", 512, 1),
         ("fsdp2xtensor2", "gpt2", 256, 1),
         ("data2xtensor2", "llama", 512, 2),
         ("data2xtensor2", "gpt2", 257, 1)]


def _name(mesh, fam, vocab, k) -> str:
    return f"{mesh}-{fam}{vocab}-accum{k}"


WORKER = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, n, store, spec_path, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
try:
    from move2kube_tpu_torch.models import gpt2, llama
    from move2kube_tpu_torch.models import train as T
    from move2kube_tpu_torch.models.moe import MoEMlp
    from move2kube_tpu_torch.obs.numerics import health_from_state
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from move2kube_tpu_torch.parallel.sharding import gather_full, layout_of

    spec = json.load(open(spec_path))
    data = np.load(spec["inputs"])
    extents = spec["mesh"]
    mesh = make_mesh(MeshConfig(**extents), device="cpu")
    rows_n = extents.get("data", 1) * extents.get("fsdp", 1)
    # the ranks of one batch coordinate (the inner axes) take its rows
    coord = rank // (n // rows_n)
    out = {}
    for case in spec["cases"]:
        fam, k, name = case["family"], case["grad_accum"], case["name"]
        if fam == "gpt2":
            cfg = dataclasses.replace(gpt2.gpt2_tiny(), dtype=torch.float32,
                                      vocab_size=case["vocab"])
        else:
            cfg = dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                                      attn_impl="flash",
                                      vocab_size=case["vocab"],
                                      moe_experts=4 if fam == "moe" else 0)
        full = {key[len(case["params"]):]: torch.from_numpy(data[key])
                for key in data.files if key.startswith(case["params"])}
        state = T.create_sharded_state(
            cfg, mesh, lambda ps: T.instrument_optimizer(
                T.Optimizer(torch.optim.SGD(ps, lr=case["lr"]))),
            device="cpu", params=full)
        for m in state.model.modules():
            if isinstance(m, MoEMlp):
                m.capacity_factor = case["capacity_factor"]
        step = T.make_lm_train_step(remat=False, grad_accum=k,
                                    chunk=case["chunk"], mesh=mesh)
        lay = layout_of(state.model)
        losses = []
        for t in range(2):
            a = data[f"{case['batches']}/batch{t}"]
            axis = 1 if k > 1 else 0
            per = a.shape[axis] // rows_n
            rows = slice(coord * per, (coord + 1) * per)
            a = a[:, rows] if axis else a[rows]
            state, loss = step(state, {"input_ids": torch.from_numpy(
                np.ascontiguousarray(a))})
            losses.append(float(loss))
            for key, p in state.model.named_parameters():
                whole = gather_full(lay, key, p.data, mesh)
                out[f"{name}/step{t}/sd/{key}"] = whole.numpy()
                part = lay.take(key, whole) if lay is not None else whole
                out[f"{name}/step{t}/part_ok/{key}"] = np.asarray(
                    part.numpy().tobytes() == p.data.numpy().tobytes())
        out[f"{name}/losses"] = np.asarray(losses, np.float64)
        out[f"{name}/grad_norm"] = np.asarray(T.grad_norm_from_state(state))
        for field, v in health_from_state(state)._asdict().items():
            out[f"{name}/health/{field}"] = v.numpy()
    np.savez(out_path, **out)
finally:
    dist.destroy_process_group()
'''


def _jax_cfg(fam, vocab):
    if fam == "gpt2":
        return dataclasses.replace(jgpt2.gpt2_tiny(), dtype=jnp.float32,
                                   vocab_size=vocab)
    return dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash", vocab_size=vocab,
                               moe_experts=4 if fam == "moe" else 0)


def _port_cfg(fam, vocab):
    from move2kube_tpu_torch.models import gpt2, llama

    if fam == "gpt2":
        return dataclasses.replace(gpt2.gpt2_tiny(), dtype=torch.float32,
                                   vocab_size=vocab)
    return dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                               attn_impl="flash", vocab_size=vocab,
                               moe_experts=4 if fam == "moe" else 0)


class _DroppingMoE(jmoe.MoEMlp):
    """The reference's MoE layer at the tests' capacity factor."""

    capacity_factor: float = CAPACITY_FACTOR


def _init(fam, vocab):
    cfg = _jax_cfg(fam, vocab)
    model = (jgpt2.GPT2 if fam == "gpt2" else jllama.Llama)(cfg)
    seed = {"llama": 0, "moe": 3, "gpt2": 1}[fam]
    ids = jnp.zeros((2, 32), jnp.int32)
    return model, jax.device_get(model.init(jax.random.PRNGKey(seed), ids))


def _batches(vocab, k, seed):
    rng = np.random.default_rng(seed)
    shape = (k, 4, 32) if k > 1 else (4, 32)
    return [rng.integers(0, vocab, shape) for _ in range(2)]


def _jax_steps(model, variables, k, batches, monkeypatch):
    """The JAX package's one-device SGD step over the global batches (an
    MoE at the tests' capacity factor)."""
    monkeypatch.setattr(jmoe, "MoEMlp", _DroppingMoE)
    monkeypatch.setenv("M2KT_CE_CHUNK", str(CHUNK))
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:1])
    state = jtrain.TrainState.create(
        apply_fn=model.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=optax.sgd(LR))
    step = jtrain.make_lm_train_step(mesh, remat=False, grad_accum=k)
    losses = []
    for ids in batches:
        state, loss = step(state, {"input_ids": jnp.asarray(ids)})
        losses.append(float(loss))
    return losses, jax.device_get(state.params)


def _port_one_device(fam, vocab, variables, k, batches):
    """The port's own step on the global batch, no mesh: (losses, the
    last update's grad norm and health summaries)."""
    from move2kube_tpu_torch.models import train as ttrain
    from move2kube_tpu_torch.models.convert import params_from_jax
    from move2kube_tpu_torch.models.gpt2 import GPT2
    from move2kube_tpu_torch.models.llama import Llama
    from move2kube_tpu_torch.models.moe import MoEMlp
    from move2kube_tpu_torch.obs.numerics import health_from_state

    cfg = _port_cfg(fam, vocab)
    model = (GPT2 if fam == "gpt2" else Llama)(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.capacity_factor = CAPACITY_FACTOR
    step = ttrain.make_lm_train_step(remat=False, grad_accum=k, chunk=CHUNK)
    state = ttrain.TrainState(model, ttrain.instrument_optimizer(
        ttrain.Optimizer(torch.optim.SGD(model.parameters(), lr=LR))))
    losses = []
    for ids in batches:
        state, loss = step(state, {"input_ids": torch.from_numpy(ids)})
        losses.append(float(loss))
    return losses, {"grad_norm": ttrain.grad_norm_from_state(state),
                    **{f: v.numpy() for f, v in
                       health_from_state(state)._asdict().items()}}


def _dropped(variables, vocab, batch) -> int:
    """Routed token-expert pairs the first MoE layer drops over the
    global batch at the tests' capacity: the port's one-device forward,
    the layer's input caught by a hook and routed again."""
    from move2kube_tpu_torch.models.convert import params_from_jax
    from move2kube_tpu_torch.models.llama import Llama
    from move2kube_tpu_torch.models.moe import capacity_for, top_k_routing

    cfg = _port_cfg("moe", vocab)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    moe = model.layers[0].moe
    seen = []
    moe.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        model(torch.from_numpy(batch))
        h = seen[0].reshape(-1, cfg.d_model)
        cap = capacity_for(h.shape[0], cfg.moe_experts, cfg.moe_top_k,
                           CAPACITY_FACTOR)
        dispatch, _, _ = top_k_routing(moe.router_logits(h),
                                       cfg.moe_experts, cfg.moe_top_k, cap)
    return h.shape[0] * cfg.moe_top_k - int(dispatch.sum())


def run_worlds(tmp, meshes, cases_in):
    """One world a mesh runs its cases while the JAX and the port's
    one-device steps run here: (each mesh's ranks' outputs, the
    references by batch)."""
    from move2kube_tpu_torch.models.convert import params_from_jax

    mp = pytest.MonkeyPatch()
    inputs, inits, want = {}, {}, {}
    cases = {mesh: [] for mesh in meshes}
    for mesh, fam, vocab, k in cases_in:
        key = f"{fam}-{vocab}"
        if key not in inits:
            inits[key] = _init(fam, vocab)
            sd = params_from_jax(inits[key][1], _port_cfg(fam, vocab))
            for leaf, t in sd.items():
                inputs[f"{key}/init/{leaf}"] = t.numpy()
        bkey = f"{key}-{k}"
        if bkey not in want:
            batches = _batches(vocab, k, 10 * k + vocab % 7)
            for t, ids in enumerate(batches):
                inputs[f"{bkey}/batch{t}"] = ids
            want[bkey] = batches
        cases[mesh].append({
            "name": _name(mesh, fam, vocab, k), "family": fam,
            "vocab": vocab, "grad_accum": k, "params": f"{key}/init/",
            "batches": bkey, "lr": LR, "chunk": CHUNK,
            "capacity_factor": CAPACITY_FACTOR})
    np.savez(tmp / "tp.npz", **inputs)
    worlds = {}
    try:
        for mesh, extents in meshes.items():
            worlds[mesh] = World(tmp, mesh, int(np.prod(list(
                extents.values()))), {"inputs": str(tmp / "tp.npz"),
                                      "mesh": extents,
                                      "cases": cases[mesh]}, WORKER)
        refs = {}
        for bkey, batches in want.items():
            fam, vocab, k = bkey.split("-")
            model, variables = inits[f"{fam}-{vocab}"]
            refs[bkey] = (_jax_steps(model, variables, int(k), batches, mp),
                          _port_one_device(fam, int(vocab), variables,
                                           int(k), batches),
                          variables, batches)
        return {mesh: w.outputs() for mesh, w in worlds.items()}, refs
    finally:
        mp.undo()
        for w in worlds.values():
            w.kill()


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    return run_worlds(tmp_path_factory.mktemp("tp"), MESHES, CASES)


IDS = [_name(*c) for c in CASES]


@pytest.mark.parametrize("mesh,fam,vocab,k", CASES, ids=IDS)
def test_tp_step_matches_the_jax_one_device_step(tp_steps, mesh, fam, vocab,
                                                 k):
    check_against_jax(tp_steps, mesh, fam, vocab, k)


@pytest.mark.parametrize("mesh,fam,vocab,k", CASES, ids=IDS)
def test_tp_ranks_hold_one_tree_and_their_slices(tp_steps, mesh, fam, vocab,
                                                 k):
    """After every step every rank's tree (whole leaves, and the cut ones
    gathered) has the same bits, and each rank's parts are its slices."""
    check_ranks(tp_steps, mesh, fam, vocab, k)


@pytest.mark.parametrize("mesh,fam,vocab,k", CASES, ids=IDS)
def test_tp_grad_norm_and_health_match_one_rank(tp_steps, mesh, fam, vocab,
                                                k):
    """The last update's grad norm and health summaries count each part
    once: one rank's numbers on the global batch."""
    check_records(tp_steps, mesh, fam, vocab, k)


def check_against_jax(steps, mesh, fam, vocab, k):
    from move2kube_tpu_torch.models.convert import params_from_jax

    got, refs = steps
    name = _name(mesh, fam, vocab, k)
    (jlosses, jparams), _, variables, batches = refs[f"{fam}-{vocab}-{k}"]
    losses = got[mesh][0][f"{name}/losses"]
    for a, b in zip(losses, jlosses):
        assert abs(a - b) <= LOSS_REL * abs(b), (losses, jlosses)
    cfg = _port_cfg(fam, vocab)
    ref = params_from_jax(jparams, cfg)
    init = params_from_jax(variables, cfg)
    for key, t in ref.items():
        mine = got[mesh][0][f"{name}/step1/sd/{key}"]
        upd = np.linalg.norm(t.numpy() - init[key].numpy())
        err = np.linalg.norm(mine - t.numpy()) / upd
        assert err < UPDATE_REL, (key, err)
    if fam == "moe":
        # the capacity drops tokens on the global batch
        first = batches[0] if k == 1 else batches[0][0]
        assert _dropped(variables, vocab, first) > 0


def check_ranks(steps, mesh, fam, vocab, k):
    got, _ = steps
    name = _name(mesh, fam, vocab, k)
    outs = got[mesh]
    for t in range(2):
        prefix = f"{name}/step{t}/sd/"
        keys = [key for key in outs[0] if key.startswith(prefix)]
        assert keys
        for r in range(1, len(outs)):
            for key in keys:
                assert outs[r][key].tobytes() == outs[0][key].tobytes(), (
                    key, r)
        for r, out in enumerate(outs):
            oks = [key for key in out
                   if key.startswith(f"{name}/step{t}/part_ok/")]
            assert oks and all(bool(out[key]) for key in oks), r


def check_records(steps, mesh, fam, vocab, k):
    got, refs = steps
    name = _name(mesh, fam, vocab, k)
    _, (_, records), _, _ = refs[f"{fam}-{vocab}-{k}"]
    for r, out in enumerate(got[mesh]):
        norm = float(out[f"{name}/grad_norm"])
        assert abs(norm - records["grad_norm"]) <= RECORD_REL * abs(
            records["grad_norm"]), (r, norm, records["grad_norm"])
        for field, ref in records.items():
            if field == "grad_norm":
                continue
            mine = out[f"{name}/health/{field}"]
            if field.endswith("nonfinite"):
                np.testing.assert_array_equal(mine, ref, err_msg=field)
            else:
                np.testing.assert_allclose(mine, ref, rtol=RECORD_REL,
                                           atol=0, err_msg=field)
