"""The port's BERT, ResNet and diffusion UNet against the JAX package's, on
the same weights: each forward (BERT with a padded mask; ResNet in
training and eval mode, at an even and an odd spatial size for the
``SAME`` padding; the UNet with ``ddpm_alpha_bars``), and two steps of
each family's train step against the JAX step: the loss of each step,
each parameter's update, and ResNet's ``batch_stats`` after.

Weights cross through ``params_from_jax``; the models run in fp32 on
the CPU. None of these families runs a TPU kernel in the JAX package,
so none runs a CUDA kernel in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from move2kube_tpu.models import bert as jbert  # noqa: E402
from move2kube_tpu.models import resnet as jresnet  # noqa: E402
from move2kube_tpu.models import train as jtrain  # noqa: E402
from move2kube_tpu.models import unet as junet  # noqa: E402
from move2kube_tpu.parallel.mesh import MeshConfig, make_mesh  # noqa: E402
from move2kube_tpu_torch.models import bert as tbert  # noqa: E402
from move2kube_tpu_torch.models import layers as tlayers  # noqa: E402
from move2kube_tpu_torch.models import resnet as tresnet  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models import unet as tunet  # noqa: E402
from move2kube_tpu_torch.models.convert import (  # noqa: E402
    init_family,
    params_from_jax,
)

# forward outputs, port vs flax, fp32: convolutions and products summed
# in other orders through every layer (tests/test_torch_llama.py's
# logits bound)
OUT_ATOL = 1e-4
# BatchNorm running statistics after a forward or a step: fp32 means
# and variances of the same activations
STATS_ATOL = 1e-5
# step losses, relative (tests/test_torch_train.py's FP32_REL)
FP32_REL = 1e-5
# each parameter's update over two steps: the norm of its difference from
# the JAX update over the JAX update's norm. The steps run plain SGD on
# both sides (optax.sgd, torch.optim.SGD in the port's Optimizer), so an
# update is the gradient itself: Adam, held to optax on equal gradients
# in tests/test_torch_train.py, divides each gradient by its own
# magnitude and moves an entry whose gradient is near zero by up to the
# learning rate on rounding noise alone
UPDATE_REL = 1e-3
LR = 0.05
# ResNet inputs are 64 pixels or more on a side, so the last stage's
# BatchNorm normalises over at least 8 values a channel: over 2 (a batch
# of 2 at 1x1, what 32 pixels leave) each output is about +-1, set by the
# sign of a difference of two nearly equal activations, and the two
# frameworks' rounding alone moves the logits past OUT_ATOL


def _mesh():
    return make_mesh(MeshConfig(), devices=jax.devices()[:1])


def _load(model, variables, cfg):
    model.load_state_dict(params_from_jax(jax.device_get(variables), cfg))
    return model


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (7, 3, 2), (8, 3, 1), (8, 1, 2), (7, 1, 2), (32, 3, 2)])
def test_same_pads_match_xla(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tlayers.same_pads(size, kernel, stride) == tuple(want[0])


def test_flax_norm_defaults():
    """flax's LayerNorm and GroupNorm epsilon (1e-6) and tanh GELU."""
    import flax.linen as fnn

    x = np.random.default_rng(0).normal(size=(2, 4, 4, 8)).astype(
        np.float32) * 3
    ln = fnn.LayerNorm()
    want = ln.apply(ln.init(jax.random.PRNGKey(0), x), x)
    got = tlayers.LayerNorm(8)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    gn = fnn.GroupNorm(num_groups=4)
    want = gn.apply(gn.init(jax.random.PRNGKey(0), x), x)
    got = tlayers.GroupNorm(4, 8)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x),
                                 approximate="tanh").numpy(),
        np.asarray(fnn.gelu(x)), atol=1e-6)


# ----------------------------------------------------------------------
# BERT
# ----------------------------------------------------------------------


def _bert_batch(seed, b=3, s=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, size=(b, s))
    mask = np.ones((b, s), bool)
    mask[1, 17:] = False  # a padded row
    mask[2, 9:] = False
    return ids, mask, rng.integers(0, 2, size=b)


@pytest.fixture(scope="module")
def bert():
    fmodel = jbert.bert_tiny(dtype=jnp.float32)
    ids, mask, _ = _bert_batch(0)
    variables = jax.device_get(jax.jit(fmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))
    cfg = tbert.bert_tiny(dtype=torch.float32)
    return fmodel, variables, cfg


@pytest.mark.parametrize("masked", [True, False])
def test_bert_forward_matches_flax(bert, masked):
    fmodel, variables, cfg = bert
    model = _load(tbert.BertEncoder(cfg, device="cpu"), variables, cfg)
    ids, mask, _ = _bert_batch(1)
    m = mask if masked else None
    want = fmodel.apply(variables, jnp.asarray(ids),
                        None if m is None else jnp.asarray(m))
    got = model(torch.from_numpy(ids),
                None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (3, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


def _update_rel(model, init_sd, after_sd):
    for name, t in model.state_dict().items():
        if name.endswith((".mean", ".var")):
            continue
        want = after_sd[name] - init_sd[name]
        err = float(torch.linalg.vector_norm(t - after_sd[name])
                    / torch.linalg.vector_norm(want))
        assert err < UPDATE_REL, (name, err)


def _run_jax(step, state, batches):
    losses = []
    for batch in batches:
        state, loss = step(state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    return state, losses


def _run_port(step, model, batches):
    opt = ttrain.Optimizer(torch.optim.SGD(model.parameters(), lr=LR))
    state = ttrain.TrainState(model, opt)
    losses = []
    for batch in batches:
        state, loss = step(state, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in batch.items()})
        losses.append(float(loss))
    return state, losses


def _close(got, want):
    for a, b in zip(got, want):
        assert abs(a - b) / abs(b) < FP32_REL, (got, want)


def test_bert_train_step_matches_jax(bert):
    fmodel, variables, cfg = bert
    batches = []
    for seed in (2, 3):
        ids, mask, label = _bert_batch(seed)
        batches.append({"input_ids": ids, "attention_mask": mask,
                        "label": label})
    state = jtrain.TrainState.create(
        apply_fn=fmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=optax.sgd(LR))
    state, want = _run_jax(jtrain.make_bert_train_step(_mesh()), state,
                           batches)
    model = _load(tbert.BertEncoder(cfg, device="cpu"), variables, cfg)
    _, got = _run_port(ttrain.make_bert_train_step(), model, batches)
    _close(got, want)
    _update_rel(model, params_from_jax(jax.device_get(variables), cfg),
                params_from_jax(jax.device_get(state.params), cfg))


# ----------------------------------------------------------------------
# ResNet
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet():
    fmodel = jresnet.resnet18_ish(num_classes=10, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    variables = jax.device_get(jax.jit(fmodel.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))
    # running statistics away from their init, so eval mode reads them
    rng = np.random.default_rng(9)
    variables["batch_stats"] = jax.tree.map(
        lambda v: (v + rng.uniform(0.1, 0.5, size=v.shape)).astype(
            np.float32), variables["batch_stats"])
    cfg = tresnet.resnet18_ish(num_classes=10, dtype=torch.float32)
    return fmodel, variables, cfg


def _resnet_model(variables, cfg):
    model = tresnet.ResNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(variables), cfg))
    return model


def _stats_close(model, params, stats, cfg):
    """The model's BatchNorm buffers equal the flax ``batch_stats``."""
    want = params_from_jax({"params": params, "batch_stats": stats}, cfg)
    for name, t in model.named_buffers():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=STATS_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("train", [True, False])
def test_resnet_forward_matches_flax(resnet, size, train):
    """Logits in training mode (batch statistics; the running ones
    updated as flax updates ``batch_stats``) and in eval mode (the
    running ones), at an even size (stride-2 3x3 SAME pads (0, 1)) and an
    odd one (it pads (1, 1))."""
    fmodel, variables, cfg = resnet
    model = _resnet_model(variables, cfg).train(train)
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    if train:
        want, upd = jax.jit(lambda v, x_: fmodel.apply(
            v, x_, train=True, mutable=["batch_stats"]))(variables,
                                                         jnp.asarray(x))
    else:
        want = jax.jit(lambda v, x_: fmodel.apply(v, x_, train=False))(
            variables, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)
    _stats_close(model, variables["params"],
                 jax.device_get(upd["batch_stats"]) if train
                 else variables["batch_stats"], cfg)


def _image_batches(seed, shape, classes=10):
    rng = np.random.default_rng(seed)
    return [{"input": rng.normal(size=shape).astype(np.float32),
             "label": rng.integers(0, classes, size=shape[:-3])}
            for _ in range(2)]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_classifier_train_step_matches_jax(resnet, grad_accum):
    """Two steps of the classifier step with ``has_batch_stats``: losses,
    every parameter's update and the running statistics after, against
    the JAX step; with ``grad_accum=2`` the statistics go through both
    microbatches of each step."""
    fmodel, variables, cfg = resnet
    shape = ((grad_accum, 2, 64, 64, 3) if grad_accum > 1
             else (2, 64, 64, 3))
    batches = _image_batches(4, shape)
    state = jtrain.TrainState.create(
        apply_fn=fmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=optax.sgd(LR),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    state, want = _run_jax(jtrain.make_classifier_train_step(
        _mesh(), has_batch_stats=True, grad_accum=grad_accum), state,
        batches)
    model = _resnet_model(variables, cfg)
    tstate, got = _run_port(ttrain.make_classifier_train_step(
        has_batch_stats=True, grad_accum=grad_accum), model, batches)
    _close(got, want)
    after = jax.device_get({"params": state.params,
                            "batch_stats": state.batch_stats})
    _update_rel(model, params_from_jax(variables, cfg),
                params_from_jax(after, cfg))
    _stats_close(model, after["params"], after["batch_stats"], cfg)
    assert set(tstate.batch_stats) == {n for n, _ in model.named_buffers()}


def test_classifier_step_needs_has_batch_stats(resnet):
    _, variables, cfg = resnet
    model = _resnet_model(variables, cfg)
    step = ttrain.make_classifier_train_step()
    state = ttrain.TrainState(model, ttrain.adam(model.parameters(), LR))
    with pytest.raises(ValueError, match="has_batch_stats"):
        step(state, {k: torch.from_numpy(v) for k, v in
                     _image_batches(5, (2, 64, 64, 3))[0].items()})


# ----------------------------------------------------------------------
# UNet
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet():
    jcfg = junet.UNetConfig(**{**junet.unet_tiny().__dict__,
                               "dtype": jnp.float32})
    fmodel = junet.UNet(jcfg)
    x = np.zeros((1, 16, 16, 3), np.float32)
    variables = jax.device_get(jax.jit(fmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((1,), jnp.int32)))
    cfg = tunet.UNetConfig(**{**tunet.unet_tiny().__dict__,
                              "dtype": torch.float32})
    return fmodel, variables, cfg


def test_ddpm_schedule_and_timestep_embedding_match_jax():
    np.testing.assert_allclose(tunet.ddpm_alpha_bars(1000).numpy(),
                               np.asarray(junet.ddpm_alpha_bars(1000)),
                               rtol=1e-6, atol=1e-7)
    t = np.array([0, 7, 999])
    np.testing.assert_allclose(
        tunet.timestep_embedding(torch.from_numpy(t), 32).numpy(),
        np.asarray(junet.timestep_embedding(jnp.asarray(t), 32)),
        atol=1e-5)


def test_unet_forward_matches_flax(unet):
    fmodel, variables, cfg = unet
    model = tunet.UNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 800])
    want = jax.jit(fmodel.apply)(variables, jnp.asarray(x), jnp.asarray(t))
    got = model(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


def test_diffusion_train_step_matches_jax(unet):
    fmodel, variables, cfg = unet
    rng = np.random.default_rng(2)
    batches = [{"image": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
                "noise": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
                "t": rng.integers(0, 1000, size=2)} for _ in range(2)]
    state = jtrain.TrainState.create(
        apply_fn=fmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=optax.sgd(LR))
    state, want = _run_jax(jtrain.make_diffusion_train_step(_mesh()), state,
                           batches)
    model = tunet.UNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg))
    _, got = _run_port(ttrain.make_diffusion_train_step(), model, batches)
    _close(got, want)
    _update_rel(model, params_from_jax(variables, cfg),
                params_from_jax(jax.device_get(state.params), cfg))


def test_init_family_draws_flax_defaults():
    """fp32 parameters, lecun-normal kernels (fan-in over the window),
    zero biases, unit norms and fresh statistics; one seed, one draw."""
    cfg = tresnet.resnet18_ish(num_classes=10)
    a = init_family(cfg, seed=3, device="cpu")
    b = init_family(cfg, seed=3, device="cpu")
    for (name, t), u in zip(a.state_dict().items(),
                            b.state_dict().values()):
        assert torch.equal(t, u), name
    w = a.blocks[0].conv2.weight
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - (1 / np.sqrt(w[0].numel()))) < 0.02
    assert float(w.abs().max()) <= 2 / np.sqrt(w[0].numel()) / \
        tlayers.TRUNC_STD + 1e-6
    assert torch.equal(a.stem_norm.var, torch.ones(16))
    assert a.head.bias.abs().max() == 0
