"""The port's data-parallel train steps (the mesh paths of
``move2kube_tpu_torch/models/train.py`` over the ring of
``parallel/overlap.py``) in a gloo world of 2 on the CPU: the LM step on
the tiny Llama and the tiny GPT-2 (``grad_accum`` 1, 2 and 4; above 1 the
overlapped path runs), the BERT step and the ResNet step with batch
statistics (``grad_accum`` 1 and 2), each two steps from the flax init
(``params_from_jax``), against the JAX package's one-device step on the
same global batch and the port's own. The reference's own overlapped path
fails on this JAX (``test_overlapped_accum_matches_plain_step``), so the
oracle is its one-device math, as ROADMAP.md says. The world runs in
spawned processes on a ``FileStore`` (``tests/test_torch_ring.py``'s
``World``) while the references run here.

Tolerances. Both sides run plain SGD (optax.sgd, ``torch.optim.SGD``):
Adam divides each gradient by its own magnitude and moves an entry whose
gradient is near zero by up to the learning rate on rounding noise alone
(``tests/test_torch_families.py``).

- Against the JAX step, Llama, GPT-2 and BERT: the loss within 1e-6
  relative (two frameworks' fp32 kernels over 2 layers; measured at most
  2e-7), each parameter's difference within 1e-5 of its norm (measured
  at most 8e-7). ResNet is held to the bounds its one-device step meets
  in ``tests/test_torch_families.py``, on that file's batches: loss 1e-5
  relative, each update 1e-3 of its norm, running statistics 1e-5. Its
  BatchNorm makes the update sensitive to rounding in the batch moments:
  on other batches of random images the port's *one-device* step is
  1e-2 to 2e-1 off the JAX one in some BatchNorm biases, and 1e-2 off
  itself with the two halves of its batch swapped.
- Against the port's own one-device step on the same global batch only
  the order of the sums differs: loss 1e-5 relative, each update within
  1e-4 of its norm (the one-device step with its batch's two halves
  swapped moves by up to 2e-5), running statistics 1e-5.
- Across ranks: the same bits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
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


STEP_CASES = [("llama", 1), ("llama", 2), ("llama", 4), ("gpt2", 1),
              ("gpt2", 2), ("gpt2", 4), ("bert", 1), ("resnet", 1),
              ("resnet", 2)]


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
    """The port's own step on the global batch, no mesh."""
    from move2kube_tpu_torch.models import train as ttrain
    from move2kube_tpu_torch.models.convert import init_family, params_from_jax

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
    state = ttrain.TrainState(model, ttrain.Optimizer(torch.optim.SGD(
        model.parameters(), lr=LR)))
    losses = []
    for batch in batches:
        state, loss = step(state, {key: torch.from_numpy(np.asarray(v))
                                   for key, v in batch.items()})
        losses.append(float(loss))
    return losses, {key: t.numpy() for key, t in model.state_dict().items()}


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """One world of 2 runs every case while the JAX and the port's
    one-device steps run here."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("steps")
    fams = _families()
    inputs, cases, batches, want = {}, [], {}, {}
    for fam, (fmodel, variables) in fams.items():
        inputs.update(_flat(variables, f"{fam}/init/"))
    for fam, k in STEP_CASES:
        name = f"{fam}-{k}"
        batches[name] = _batches(fam, k)
        for t, batch in enumerate(batches[name]):
            for key, v in batch.items():
                inputs[f"{name}/batch{t}/{key}"] = v
        cases.append({"name": name, "family": fam, "grad_accum": k,
                      "keys": sorted(batches[name][0]), "lr": LR,
                      "chunk": CHUNK})
    np.savez(tmp / "steps.npz", **inputs)
    world = World(tmp, "steps", 2, {
        "job": "steps", "inputs": str(tmp / "steps.npz"), "cases": cases})
    try:
        for fam, k in STEP_CASES:
            name = f"{fam}-{k}"
            fmodel, variables = fams[fam]
            want[name] = (
                _jax_steps(fam, fmodel, variables, k, batches[name], mp),
                _port_one_device(fam, variables, k, batches[name]),
                variables)
        return world.outputs(), want
    finally:
        mp.undo()
        world.kill()


def _case_ids():
    return [f"{f}-accum{k}" for f, k in STEP_CASES]


@pytest.mark.parametrize("fam,k", STEP_CASES, ids=_case_ids())
def test_dp_step_matches_the_jax_one_device_step(dp_steps, fam, k):
    from move2kube_tpu_torch.models.convert import params_from_jax

    got, want = dp_steps
    name = f"{fam}-{k}"
    (jlosses, jafter), _, variables = want[name]
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


@pytest.mark.parametrize("fam,k", STEP_CASES, ids=_case_ids())
def test_dp_step_matches_the_ports_one_device_step(dp_steps, fam, k):
    """Only the order of the sums differs from the port's step on the
    whole global batch."""
    from move2kube_tpu_torch.models.convert import params_from_jax

    got, want = dp_steps
    name = f"{fam}-{k}"
    _, (plosses, pafter), variables = want[name]
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


@pytest.mark.parametrize("fam,k", STEP_CASES, ids=_case_ids())
def test_dp_ranks_end_bit_identical(dp_steps, fam, k):
    got, _ = dp_steps
    name = f"{fam}-{k}"
    keys = [key for key in got[0] if key.startswith(f"{name}/")]
    assert keys and set(keys) == {key for key in got[1]
                                  if key.startswith(f"{name}/")}
    for key in keys:
        assert got[0][key].tobytes() == got[1][key].tobytes(), key
