"""The port's tensor-health plane against the JAX package's
(``move2kube_tpu/obs/numerics.py``): the layer groups of every family's
converted tree, the group summaries on trees with planted NaN and Inf,
the first bad group, the ``<flight>.numerics`` sidecar, and the health
recorder the optimizer carries.

Env knobs are set through ``monkeypatch`` only and point under
``tmp_path``; every test builds its own registry and optimizer.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from move2kube_tpu.models import bert as jbert  # noqa: E402
from move2kube_tpu.models import gpt2 as jgpt2  # noqa: E402
from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.models import precision as jprec  # noqa: E402
from move2kube_tpu.models import resnet as jresnet  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.models import unet as junet  # noqa: E402
from move2kube_tpu.obs import numerics as jnum  # noqa: E402
from move2kube_tpu_torch.models import bert as tbert  # noqa: E402
from move2kube_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import precision as tprec  # noqa: E402
from move2kube_tpu_torch.models import resnet as tresnet  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models import unet as tunet  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs import numerics as tnum  # noqa: E402

# group rms: sums of squares of the same fp32 values in other orders
# (the port folds per-leaf partial sums, XLA reduces one concatenation)
RMS_REL = 1e-6
LAYERS = 12  # more than 10, so layer_10 sorts before layer_2


def _llama_cfgs(layers=LAYERS, **kw):
    jcfg = dataclasses.replace(jllama.llama_tiny(), num_layers=layers,
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tllama.llama_tiny(), num_layers=layers,
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _shapes(init, *args):
    """The flax tree's abstract params (no draws)."""
    return jax.eval_shape(init, jax.random.PRNGKey(0), *args)


def _family(name):
    """(reference params tree of shapes, port model) for one family."""
    if name in ("llama", "moe"):
        kw = {"moe_experts": 4} if name == "moe" else {}
        jcfg, tcfg = _llama_cfgs(**kw)
        tree = _shapes(jllama.Llama(jcfg).init, jnp.zeros((1, 8), jnp.int32))
        return tree["params"], tllama.Llama(tcfg, device="cpu")
    if name == "gpt2":
        jcfg = dataclasses.replace(jgpt2.gpt2_tiny(), num_layers=LAYERS)
        tcfg = dataclasses.replace(tgpt2.gpt2_tiny(), num_layers=LAYERS,
                                   dtype=torch.float32)
        tree = _shapes(jgpt2.GPT2(jcfg).init, jnp.zeros((1, 8), jnp.int32))
        return tree["params"], tgpt2.GPT2(tcfg, device="cpu")
    if name == "bert":
        fmodel = jbert.bert_tiny(dtype=jnp.float32)
        ids = jnp.zeros((1, 8), jnp.int32)
        tree = _shapes(fmodel.init, ids, jnp.ones((1, 8), bool))
        return tree["params"], tbert.BertEncoder(
            tbert.bert_tiny(dtype=torch.float32), device="cpu")
    if name == "resnet":
        fmodel = jresnet.resnet18_ish(num_classes=10, dtype=jnp.float32)
        tree = _shapes(fmodel.init, jnp.zeros((1, 32, 32, 3)))
        return tree["params"], tresnet.ResNet(
            tresnet.resnet18_ish(num_classes=10, dtype=torch.float32),
            device="cpu")
    jcfg = junet.UNetConfig(**{**junet.unet_tiny().__dict__,
                               "dtype": jnp.float32})
    tree = _shapes(junet.UNet(jcfg).init, jnp.zeros((1, 16, 16, 3)),
                   jnp.zeros((1,), jnp.int32))
    return tree["params"], tunet.UNet(tunet.unet_tiny(), device="cpu")


@pytest.mark.parametrize("family", ["llama", "gpt2", "moe", "bert",
                                    "resnet", "unet"])
def test_group_index_matches_reference(family):
    """Names and order equal the reference's (its tree-flatten order),
    and each group holds the same number of entries on both sides."""
    tree, model = _family(family)
    jnames, jleaf = jnum.group_index(tree)
    tnames, tleaf = tnum.group_index(model)
    assert tnames == jnames
    if family in ("llama", "moe"):
        assert tnames.index("layer_10") < tnames.index("layer_2")
    jsize = np.zeros(len(jnames), np.int64)
    for g, leaf in zip(jleaf, jax.tree_util.tree_leaves(tree)):
        jsize[g] += int(np.prod(leaf.shape))
    tsize = np.zeros(len(tnames), np.int64)
    for g, (_, p) in zip(tleaf, model.named_parameters()):
        tsize[g] += p.numel()
    np.testing.assert_array_equal(tsize, jsize)


def _planted_tree(dtype):
    """A 12-layer tiny Llama's flax params (fp32 draws) with NaN and Inf
    planted in three groups, plus an integer leaf; the same values as the
    port's state dict (plus the integer leaf under its port name)."""
    jcfg, tcfg = _llama_cfgs()
    params = jax.device_get(jllama.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    params = jax.tree.map(np.array, params)
    params["layer_3"]["qkv"]["kernel"][2, 5] = np.nan
    params["layer_10"]["down"]["kernel"][0, :3] = np.inf
    params["layer_10"]["mlp_norm"]["scale"][1] = -np.inf
    params["lm_head"]["kernel"][7, 7] = np.nan
    sd = params_from_jax(params, tcfg)
    sd = {k: v.to(dtype) for k, v in sd.items()}
    jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.dtype(
        str(dtype).removeprefix("torch."))), params)
    jtree["layer_0"]["steps"] = jnp.arange(6, dtype=jnp.int32)
    sd["layers.0.steps"] = torch.arange(6, dtype=torch.int32)
    return jtree, sd, tcfg


def _check_summaries(ours, theirs):
    rms, max_abs, nonfinite = (t.numpy() for t in ours)
    j_rms, j_max, j_nf = (np.asarray(t) for t in theirs)
    np.testing.assert_allclose(rms, j_rms, rtol=RMS_REL, atol=0)
    assert np.array_equal(np.isinf(max_abs), np.isinf(j_max))
    fin = np.isfinite(j_max)
    np.testing.assert_allclose(max_abs[fin], j_max[fin], rtol=RMS_REL)
    np.testing.assert_array_equal(nonfinite, j_nf)
    assert nonfinite.dtype == np.int32 and rms.dtype == np.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_summarize_tree_matches_reference(dtype):
    jtree, sd, tcfg = _planted_tree(dtype)
    names, leaf_groups = tnum.group_index(sd, tcfg)
    jnames, jleaf = jnum.group_index(jtree)
    assert names == jnames
    ours = tnum.summarize_tree(list(sd.values()), leaf_groups, len(names))
    theirs = jnum.summarize_tree(jtree, jleaf, len(jnames))
    _check_summaries(ours, theirs)
    nf = dict(zip(names, ours[2].tolist()))
    assert nf["layer_3"] == 1 and nf["layer_10"] == 4 and nf["lm_head"] == 1
    assert nf["embed"] == 0


def test_first_bad_group_and_sidecar_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "flight.json"))
    jtree, sd, tcfg = _planted_tree(torch.float32)
    names, leaf_groups = tnum.group_index(sd, tcfg)
    state = tnum.TensorHealthState(
        *tnum.summarize_tree(list(sd.values()), leaf_groups, len(names)),
        *tnum.summarize_tree(list(sd.values()), leaf_groups, len(names)))
    doc = tnum.summary(names, state)
    jdoc = jnum.summary(names, jnum.TensorHealthState(
        *jnum.summarize_tree(jtree), *jnum.summarize_tree(jtree)))
    assert list(doc) == list(jdoc)
    # layer_10 sorts before layer_3: the earliest in tree order
    assert tnum.first_bad_group(doc) == jnum.first_bad_group(jdoc) == (
        "layer_10")
    clean = {n: dict(f, grad_nonfinite=0.0, param_nonfinite=0.0)
             for n, f in doc.items()}
    assert tnum.first_bad_group(clean) is jnum.first_bad_group(clean) is None
    assert tnum.sidecar_path() == jnum.sidecar_path() == str(
        tmp_path / "flight.json.numerics")
    sidecar = {"step": 3, "first_bad_group": "layer_10", "groups": doc}
    assert tnum.write_sidecar(sidecar) == tnum.sidecar_path()
    assert jnum.read_sidecar() == tnum.read_sidecar() == sidecar
    assert tnum.read_sidecar(str(tmp_path / "missing")) is None


def _tiny_llama(layers=LAYERS):
    jcfg, tcfg = _llama_cfgs(layers)
    params = jax.device_get(jllama.Llama(jcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg))
    return params, model


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params)


@pytest.mark.parametrize("knob", ["1", "0"])
def test_recorder_state_shape_is_the_same_on_and_off(knob, monkeypatch):
    monkeypatch.setenv("M2KT_NUMERICS", knob)
    params, model = _tiny_llama(layers=3)
    opt = ttrain.instrument_optimizer(ttrain.adam(model.parameters(), 1e-3))
    state = ttrain.TrainState(model, opt)
    before = tnum.health_from_state(state)
    names = tnum.group_index(model)[0]
    assert [tuple(t.shape) for t in before] == [(len(names),)] * 6
    assert [t.dtype for t in before] == [torch.float32, torch.float32,
                                         torch.int32] * 2
    jstate = jtrain.instrument_optimizer(optax.adam(1e-3)).init(
        jax.tree.map(jnp.asarray, params))
    jhealth = jnum.health_from_state(jstate)
    assert [tuple(t.shape) for t in before] == [t.shape for t in jhealth]
    gen = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    after = tnum.health_from_state(opt)
    assert [tuple(t.shape) for t in after] == [tuple(t.shape)
                                               for t in before]
    recorded = bool(after.grad_rms.abs().sum() > 0)
    assert recorded == (knob == "1")


def test_guard_skipped_update_is_recorded_as_the_reference_records_it():
    """An Inf gradient in layer_7 under ``bf16-scaled``: the guard skips
    the update on both sides, and both record the same summaries of the
    gradients that poisoned it and of the parameters it left alone."""
    params, model = _tiny_llama()
    grads = _grads(params, 3)
    grads["layer_7"]["gate_up"]["kernel"][4, 1] = np.inf
    grads["embed"]["embedding"][2, 2] = np.nan
    tcfg = model.cfg
    opt = ttrain.instrument_optimizer(tprec.policy("bf16-scaled")
                                      .wrap_optimizer(ttrain.adamw(
                                          model.parameters(), 1e-3, 0.1)))
    state = ttrain.TrainState(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tgrads = params_from_jax(grads, tcfg)
    for name, p in model.named_parameters():
        p.grad = tgrads[name].clone()
    assert opt.step() is False
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name])
    tx = jtrain.instrument_optimizer(jprec.policy("bf16-scaled")
                                     .wrap_optimizer(optax.adamw(1e-3, 0.1)))
    jparams = jax.tree.map(jnp.asarray, params)
    _, jopt = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(jparams),
                        jparams)
    ours, theirs = tnum.health_from_state(state), jnum.health_from_state(jopt)
    _check_summaries(ours[:3], theirs[:3])
    _check_summaries(ours[3:], theirs[3:])
    doc = tnum.summary(opt.health_names, ours)
    jdoc = jnum.summary(jnum.group_index(jparams)[0], theirs)
    assert tnum.first_bad_group(doc) == jnum.first_bad_group(jdoc) == "embed"
    assert doc["layer_7"]["grad_nonfinite"] == 1.0
    assert doc["layer_7"]["grad_max_abs"] == float("inf")


def test_health_from_state_finds_the_state():
    _, model = _tiny_llama(layers=2)
    opt = ttrain.adam(model.parameters(), 1e-3)
    state = ttrain.TrainState(model, opt)
    assert tnum.health_from_state(state) is None
    ttrain.instrument_optimizer(opt)
    health = tnum.health_from_state(state)
    assert isinstance(health, tnum.TensorHealthState)
    assert tnum.health_from_state(opt) is health
    assert tnum.health_from_state(health) is health
    assert opt.health_names == tnum.group_index(model)[0]
