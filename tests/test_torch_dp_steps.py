"""The port's mesh train steps (``move2kube_tpu_torch/models/train.py``
over the rings of ``parallel/overlap.py``) in gloo worlds on the CPU, on
three meshes: ``data=2`` (the data path), ``fsdp=2`` (ZeRO-3: parameters
sharded by ``shard_params``, under both schedules, the prefetched one and
``M2KT_FSDP_PREFETCH=off``'s sequential one) and ``data=2 x fsdp=2`` (a
world of 4, the sequential schedule). The LM step on the tiny Llama and
the tiny GPT-2 (``grad_accum`` 1, 2 and 4 on the data mesh, 1 and 2 on the
fsdp ones), the BERT step and the ResNet step with batch statistics, each
two steps from the flax init (``params_from_jax``), against the JAX
package's one-device step on the same global batch and the port's own,
both computed once for all three meshes. The reference's own overlapped
and FSDP paths fail on this JAX (``test_overlapped_accum_matches_plain_
step``, ``tests/test_crossentropy.py``'s FSDP tests), so the oracle is its
one-device math, as ROADMAP.md says. The worlds run in spawned processes
on ``FileStore``s (``tests/test_torch_ring.py``'s ``World``) while the
references run here. ResNet's rows at ``data=2 x fsdp=2`` are its two
rows twice (4 rows for 4 ranks): the batch statistics, the loss and the
gradients of the doubled batch are those of the two rows, so that case
is held to the JAX step on the two rows (and to the port's one-device
step on the four).

Tolerances. Both sides run plain SGD (optax.sgd, ``torch.optim.SGD``):
Adam divides each gradient by its own magnitude and moves an entry whose
gradient is near zero by up to the learning rate on rounding noise alone
(``tests/test_torch_families.py``).

- Against the JAX step, Llama, GPT-2 and BERT: the loss within 1e-6
  relative (two frameworks' fp32 kernels over 2 layers; measured at most
  2e-7), each parameter's difference within 1e-5 of its norm (measured
  at most 8e-7); on the fsdp meshes the parameter is the gathered one.
  ResNet is held to the bounds its one-device step meets in
  ``tests/test_torch_families.py``, on that file's batches: loss 1e-5
  relative, each update 1e-3 of its norm, running statistics 1e-5. Its
  BatchNorm makes the update sensitive to rounding in the batch moments:
  on other batches of random images the port's *one-device* step is
  1e-2 to 2e-1 off the JAX one in some BatchNorm biases, and 1e-2 off
  itself with the two halves of its batch swapped.
- Against the port's own one-device step on the same global batch only
  the order of the sums differs: loss 1e-5 relative, each update within
  1e-4 of its norm (the one-device step with its batch's two halves
  swapped moves by up to 2e-5), running statistics 1e-5. On the fsdp
  meshes, the grad norm and the tensor-health summaries of the last
  update within 1e-6 relative of the one-device step's (the same sums
  over shards and ranks in another order).
- Across ranks: the same bits (the replicated leaves, and on the fsdp
  meshes the gathered tree); each rank's shard is its slice of the
  gathered tree, bit for bit.
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

from move2kube_tpu.models import bert as jbert  # noqa: E402
from move2kube_tpu.models import gpt2 as jgpt2  # noqa: E402
from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.models import resnet as jresnet  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu_torch.parallel.sharding import param_specs  # noqa: E402
from tests.test_torch_ring import (  # noqa: E402,F401
    World,
    _process_state_unchanged,
)

LOSS_REL = 1e-6
PARAM_REL = 1e-5
# ResNet against the JAX step: tests/test_torch_families.py's bounds
RESNET_LOSS_REL = 1e-5
RESNET_UPDATE_REL = 1e-3
STATS_ATOL = 1e-5
# against the port's one-device step: the sums in another order
ORDER_LOSS_REL = 1e-5
ORDER_UPDATE_REL = 1e-4
# the grad norm and the health summaries against one rank's; ResNet's at
# its update bound, since its BatchNorm moves its gradients with the order
# of the batch sums (measured 8.2e-6 at data=2 x fsdp=2)
RECORD_REL = 1e-6
RESNET_RECORD_REL = ORDER_UPDATE_REL
LR = 0.05
CHUNK = 128


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _lm_batches(vocab, k, seed, b=4, s=32):
    rng = np.random.default_rng(seed)
    shape = (k, b, s) if k > 1 else (b, s)
    return [{"input_ids": rng.integers(0, vocab, shape)} for _ in range(2)]


def _families():
    """Each family's flax model, its init variables and the batches."""
    out = {}
    jl = jllama.Llama(dataclasses.replace(jllama.llama_tiny(),
                                          dtype=jnp.float32,
                                          attn_impl="flash"))
    ids = jnp.zeros((2, 32), jnp.int32)
    out["llama"] = (jl, jax.device_get(jl.init(jax.random.PRNGKey(0), ids)))
    jg = jgpt2.GPT2(dataclasses.replace(jgpt2.gpt2_tiny(), dtype=jnp.float32))
    out["gpt2"] = (jg, jax.device_get(jg.init(jax.random.PRNGKey(1), ids)))
    jb = jbert.bert_tiny(dtype=jnp.float32)
    out["bert"] = (jb, jax.device_get(jb.init(
        jax.random.PRNGKey(2), jnp.zeros((2, 24), jnp.int32),
        jnp.ones((2, 24), bool))))
    jr = jresnet.resnet18_ish(num_classes=10, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    variables = jax.device_get(jax.jit(jr.init)(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    rng = np.random.default_rng(9)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (v + rng.uniform(0.1, 0.5, size=v.shape)).astype(
            np.float32), variables["batch_stats"])
    out["resnet"] = (jr, variables)
    return out


# (mesh, family, grad_accum, schedule): "auto" prefetches on a pure fsdp
# mesh, "off" is M2KT_FSDP_PREFETCH=off's sequential schedule
MESHES = {"data2": {"data": 2}, "fsdp2": {"fsdp": 2},
          "data2xfsdp2": {"data": 2, "fsdp": 2}}
STEP_CASES = (
    [("data2", f, k, "auto") for f, k in (
        ("llama", 1), ("llama", 2), ("llama", 4), ("gpt2", 1), ("gpt2", 2),
        ("gpt2", 4), ("bert", 1), ("resnet", 1), ("resnet", 2))]
    + [("fsdp2", f, k, sched) for f in ("llama", "gpt2") for k in (1, 2)
       for sched in ("auto", "off")]
    + [("fsdp2", "bert", 1, "auto"), ("fsdp2", "resnet", 1, "auto")]
    + [("data2xfsdp2", f, k, "auto") for f, k in (
        ("llama", 1), ("llama", 2), ("gpt2", 1), ("gpt2", 2), ("bert", 1),
        ("resnet", 1))])


def _batch_key(mesh, fam, k) -> str:
    """The batches a case runs on (shared across meshes): ResNet's two
    rows are doubled for a world of four."""
    doubled = fam == "resnet" and mesh == "data2xfsdp2"
    return f"{fam}-{k}" + ("-x2" if doubled else "")


def _case_name(mesh, fam, k, sched) -> str:
    return f"{mesh}-{fam}-{k}-{sched}"


def _batches(fam, k):
    if fam == "llama":
        return _lm_batches(512, k, 10 + k)
    if fam == "gpt2":
        return _lm_batches(256, k, 20 + k)
    rng = np.random.default_rng(30 + k)
    if fam == "bert":
        out = []
        for _ in range(2):
            mask = np.ones((4, 24), bool)
            mask[1, 17:] = False
            mask[3, 9:] = False
            out.append({"input_ids": rng.integers(1, 1024, (4, 24)),
                        "attention_mask": mask,
                        "label": rng.integers(0, 2, 4)})
        return out
    # tests/test_torch_families.py's ResNet batches (seed 4, two rows),
    # on which the port's one-device step holds to the JAX one
    rng = np.random.default_rng(4)
    shape = (k, 2, 64, 64, 3) if k > 1 else (2, 64, 64, 3)
    return [{"input": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, 10, size=shape[:-3])}
            for _ in range(2)]


def _doubled(batches):
    return [{key: np.concatenate([v, v]) for key, v in b.items()}
            for b in batches]


def _jax_steps(fam, fmodel, variables, k, batches, monkeypatch):
    mesh = make_mesh(MeshConfig(), devices=jax.devices()[:1])
    stats = variables.get("batch_stats")
    state = jtrain.TrainState.create(
        apply_fn=fmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=optax.sgd(LR),
        batch_stats=(jax.tree.map(jnp.asarray, stats)
                     if stats is not None else None))
    if fam in ("llama", "gpt2"):
        monkeypatch.setenv("M2KT_CE_CHUNK", str(CHUNK))
        step = jtrain.make_lm_train_step(mesh, remat=False, grad_accum=k)
    elif fam == "bert":
        step = jtrain.make_bert_train_step(mesh)
    else:
        step = jtrain.make_classifier_train_step(
            mesh, has_batch_stats=True, grad_accum=k)
    losses = []
    for batch in batches:
        state, loss = step(state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    after = {"params": state.params}
    if stats is not None:
        after["batch_stats"] = state.batch_stats
    return losses, jax.device_get(after)


def _cfg(fam):
    from move2kube_tpu_torch.models import bert, gpt2, llama, resnet

    if fam == "llama":
        return dataclasses.replace(llama.llama_tiny(), dtype=torch.float32,
                                   attn_impl="flash")
    if fam == "gpt2":
        return dataclasses.replace(gpt2.gpt2_tiny(), dtype=torch.float32)
    if fam == "bert":
        return bert.bert_tiny(dtype=torch.float32)
    return resnet.resnet18_ish(num_classes=10, dtype=torch.float32)


def _port_one_device(fam, variables, k, batches):
    """The port's own step on the global batch, no mesh, with its
    optimizer instrumented: (losses, parameters, the last update's grad
    norm and health summaries)."""
    from move2kube_tpu_torch.models import train as ttrain
    from move2kube_tpu_torch.models.convert import init_family, params_from_jax
    from move2kube_tpu_torch.obs.numerics import health_from_state

    cfg = _cfg(fam)
    if fam == "llama":
        from move2kube_tpu_torch.models.llama import Llama as cls
    elif fam == "gpt2":
        from move2kube_tpu_torch.models.gpt2 import GPT2 as cls
    else:
        cls = None
    model = (cls(cfg, device="cpu") if cls is not None
             else init_family(cfg, device="cpu"))
    model.load_state_dict(params_from_jax(variables, cfg))
    if fam in ("llama", "gpt2"):
        step = ttrain.make_lm_train_step(remat=False, grad_accum=k,
                                         chunk=CHUNK)
    elif fam == "bert":
        step = ttrain.make_bert_train_step()
    else:
        step = ttrain.make_classifier_train_step(has_batch_stats=True,
                                                 grad_accum=k)
    state = ttrain.TrainState(model, ttrain.instrument_optimizer(
        ttrain.Optimizer(torch.optim.SGD(model.parameters(), lr=LR))))
    losses = []
    for batch in batches:
        state, loss = step(state, {key: torch.from_numpy(np.asarray(v))
                                   for key, v in batch.items()})
        losses.append(float(loss))
    records = {"grad_norm": ttrain.grad_norm_from_state(state),
               **{f: v.numpy() for f, v in
                  health_from_state(state)._asdict().items()}}
    return (losses, {key: t.numpy() for key, t in
                     model.state_dict().items()}, records)


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """One world a mesh runs its cases while the JAX and the port's
    one-device steps run here, once for every mesh."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("steps")
    fams = _families()
    inputs, batches, want, worlds = {}, {}, {}, {}
    for fam, (fmodel, variables) in fams.items():
        inputs.update(_flat(variables, f"{fam}/init/"))
    cases = {mesh: [] for mesh in MESHES}
    for mesh, fam, k, sched in STEP_CASES:
        key = _batch_key(mesh, fam, k)
        if key not in batches:
            batches[key] = (_doubled(_batches(fam, k)) if key.endswith("x2")
                            else _batches(fam, k))
            for t, batch in enumerate(batches[key]):
                for name, v in batch.items():
                    inputs[f"{key}/batch{t}/{name}"] = v
        cases[mesh].append({
            "name": _case_name(mesh, fam, k, sched), "batches": key,
            "family": fam, "grad_accum": k, "prefetch": sched,
            "keys": sorted(batches[key][0]), "lr": LR, "chunk": CHUNK})
    np.savez(tmp / "steps.npz", **inputs)
    try:
        for mesh, extents in MESHES.items():
            n = int(np.prod(list(extents.values())))
            worlds[mesh] = World(tmp, f"steps-{mesh}", n, {
                "job": "steps", "inputs": str(tmp / "steps.npz"),
                "mesh": extents, "cases": cases[mesh]})
        for key, bs in batches.items():
            fam, k = key.split("-")[0], int(key.split("-")[1])
            fmodel, variables = fams[fam]
            # the JAX step on the doubled rows' math: the two rows
            jkey = key.removesuffix("-x2")
            jax_steps = (want[jkey][0] if jkey in want else _jax_steps(
                fam, fmodel, variables, k, batches[jkey], mp))
            want[key] = (jax_steps, _port_one_device(fam, variables, k, bs),
                         variables)
        return {mesh: w.outputs() for mesh, w in worlds.items()}, want
    finally:
        mp.undo()
        for w in worlds.values():
            w.kill()


def _case_ids(cases):
    return [f"{f}-accum{k}" if mesh == "data2" else
            f"{mesh}-{f}-accum{k}" + ("-seq" if sched == "off" else "")
            for mesh, f, k, sched in cases]


FSDP_CASES = [c for c in STEP_CASES if c[0] != "data2"]


@pytest.mark.parametrize("mesh,fam,k,sched", STEP_CASES,
                         ids=_case_ids(STEP_CASES))
def test_dp_step_matches_the_jax_one_device_step(dp_steps, mesh, fam, k,
                                                 sched):
    from move2kube_tpu_torch.models.convert import params_from_jax

    got, want = dp_steps
    got = got[mesh]
    name = _case_name(mesh, fam, k, sched)
    (jlosses, jafter), _, variables = want[_batch_key(mesh, fam, k)]
    resnet = fam == "resnet"
    losses = got[0][f"{name}/losses"]
    for a, b in zip(losses, jlosses):
        assert abs(a - b) / abs(b) < (RESNET_LOSS_REL if resnet
                                      else LOSS_REL), (losses, jlosses)
    ref = params_from_jax(jafter, _cfg(fam))
    init = params_from_jax(variables, _cfg(fam))
    for key, t in ref.items():
        mine, t = got[0][f"{name}/sd/{key}"], t.numpy()
        if key.endswith((".mean", ".var")):
            np.testing.assert_allclose(mine, t, atol=STATS_ATOL, rtol=0,
                                       err_msg=key)
        elif resnet:
            upd = np.linalg.norm(t - init[key].numpy())
            err = np.linalg.norm(mine - t) / upd
            assert err < RESNET_UPDATE_REL, (key, err)
        else:
            err = np.linalg.norm(mine - t) / np.linalg.norm(t)
            assert err < PARAM_REL, (key, err)


@pytest.mark.parametrize("mesh,fam,k,sched", STEP_CASES,
                         ids=_case_ids(STEP_CASES))
def test_dp_step_matches_the_ports_one_device_step(dp_steps, mesh, fam, k,
                                                   sched):
    """Only the order of the sums differs from the port's step on the
    whole global batch."""
    from move2kube_tpu_torch.models.convert import params_from_jax

    got, want = dp_steps
    got = got[mesh]
    name = _case_name(mesh, fam, k, sched)
    _, (plosses, pafter, _), variables = want[_batch_key(mesh, fam, k)]
    init = params_from_jax(variables, _cfg(fam))
    np.testing.assert_allclose(got[0][f"{name}/losses"], plosses,
                               rtol=ORDER_LOSS_REL)
    for key, t in pafter.items():
        mine = got[0][f"{name}/sd/{key}"]
        if key.endswith((".mean", ".var")):
            np.testing.assert_allclose(mine, t, atol=STATS_ATOL, rtol=0,
                                       err_msg=key)
            continue
        upd = t - init[key].numpy()
        err = np.linalg.norm(mine - t) / max(np.linalg.norm(upd), 1e-30)
        assert err < ORDER_UPDATE_REL, (key, err)


@pytest.mark.parametrize("mesh,fam,k,sched", STEP_CASES,
                         ids=_case_ids(STEP_CASES))
def test_dp_ranks_end_bit_identical(dp_steps, mesh, fam, k, sched):
    """Every rank ends with the same bits: the parameters (gathered on
    the fsdp meshes), the loss and the records; on the fsdp meshes each
    rank's shard is its slice of the gathered tree."""
    got, _ = dp_steps
    got = got[mesh]
    name = _case_name(mesh, fam, k, sched)
    prefix, shards = f"{name}/", f"{name}/shard/"
    keys = [key for key in got[0] if key.startswith(prefix)
            and not key.startswith(shards)]
    assert keys
    n = len(got)
    for r in range(1, n):
        assert set(keys) == {key for key in got[r] if key.startswith(prefix)
                             and not key.startswith(shards)}
        for key in keys:
            assert got[r][key].tobytes() == got[0][key].tobytes(), (key, r)
    if mesh == "data2":
        return
    extents = MESHES[mesh]
    specs = param_specs(_meta(fam), extents)
    fsdp = extents["fsdp"]
    sharded = 0
    for r in range(n):
        coord = r % fsdp  # fsdp is the inner axis
        for key in got[r]:
            if not key.startswith(shards):
                continue
            leaf = key[len(shards):]
            full = got[r][f"{name}/sd/{leaf}"]
            dim = specs[leaf].dim_of("fsdp") if leaf in specs else None
            if dim is not None:
                size = full.shape[dim] // fsdp
                full = np.take(full, np.arange(coord * size,
                                               (coord + 1) * size), axis=dim)
                sharded += 1
            assert got[r][key].tobytes() == full.tobytes(), (leaf, r)
    # a conv family shards nothing; the others shard their dense kernels
    assert (sharded == 0) == (fam == "resnet")


def _meta(fam):
    from move2kube_tpu_torch.models.convert import meta_model

    return meta_model(_cfg(fam))


@pytest.mark.parametrize("mesh,fam,k,sched", FSDP_CASES,
                         ids=_case_ids(FSDP_CASES))
def test_fsdp_grad_norm_and_health_match_one_rank(dp_steps, mesh, fam, k,
                                                  sched):
    """The last update's global grad norm and tensor-health summaries on
    every rank of a sharded tree are one rank's unsharded numbers: each
    shard and each replicated leaf counted once."""
    got, want = dp_steps
    name = _case_name(mesh, fam, k, sched)
    _, (_, _, records), _ = want[_batch_key(mesh, fam, k)]
    rel = RESNET_RECORD_REL if fam == "resnet" else RECORD_REL
    for r, out in enumerate(got[mesh]):
        norm = float(out[f"{name}/grad_norm"])
        assert abs(norm - records["grad_norm"]) <= rel * abs(
            records["grad_norm"]), (r, norm, records["grad_norm"])
        for field, ref in records.items():
            if field == "grad_norm":
                continue
            mine = out[f"{name}/health/{field}"]
            if field.endswith("nonfinite"):
                np.testing.assert_array_equal(mine, ref, err_msg=field)
            else:
                np.testing.assert_allclose(mine, ref, rtol=rel, atol=0,
                                           err_msg=field)
