"""The port's chunked cross-entropy against the JAX package's
(``move2kube_tpu/ops/crossentropy.py``), after tests/test_crossentropy.py.

Inputs come from numpy with a seed and go through both sides. The port's
head weight is ``[V, D]`` (``nn.Linear``); the JAX functions take ``[D,
V]``, so the tests hand the JAX side the transpose and compare the weight
gradient transposed back.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.ops import crossentropy as jce  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.ops import crossentropy as tce  # noqa: E402

# fp32: chunk reassociation of the logsumexp in two frameworks
# (tests/test_crossentropy.py holds the JAX paths to each other at 1e-6)
LOSS_ATOL = 1e-6
GRAD_ATOL = 1e-6
# head-folded grads: products of [48, 32] by [32, 512] in two orders
# (the JAX test's 1e-5)
LINEAR_GRAD_ATOL = 1e-5
# bf16 inputs: grads within 5 % relative norm (the JAX bf16 gate)
BF16_REL = 5e-2


def _logits(n=64, v=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, v)).astype(np.float32),
            rng.integers(0, v, n).astype(np.int32))


def _grad(fn, *xs):
    ts = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
          for x in xs]
    loss = fn(*ts)
    grads = torch.autograd.grad(loss, ts)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("vocab,requested", [
    (4096, 2048), (32000, 2048), (512, 2048), (65537, 2048), (96, 64),
    (512, 128), (50257, 2048), (128256, 2048), (1000, 7), (130, 64)])
def test_pick_chunk_matches_jax(vocab, requested):
    assert tce.pick_chunk(vocab, requested) == jce.pick_chunk(vocab,
                                                              requested)
    assert tce.DEFAULT_CHUNK == jce.DEFAULT_CHUNK


@pytest.mark.parametrize("chunk", [512, 64])
def test_fused_ce_matches_jax_fp32(chunk):
    """Loss and logits-grad at fp32 against the JAX fused and reference
    losses, one and several chunks, labels pinned on chunk boundaries."""
    logits, labels = _logits()
    labels[:4] = [0, chunk - 1, chunk % 512, 511]
    tl = torch.from_numpy(labels)
    loss, (grad,) = _grad(lambda x: tce.fused_cross_entropy(x, tl, chunk),
                          logits)
    jl = jnp.asarray(labels)
    for fn in (lambda x: jce.fused_cross_entropy(x, jl, chunk=chunk),
               lambda x: jce.reference_cross_entropy(x, jl)):
        jloss, jgrad = jax.value_and_grad(fn)(jnp.asarray(logits))
        np.testing.assert_allclose(loss, float(jloss), atol=LOSS_ATOL)
        np.testing.assert_allclose(grad, np.asarray(jgrad), atol=GRAD_ATOL)
    ref = float(tce.reference_cross_entropy(torch.from_numpy(logits), tl))
    np.testing.assert_allclose(loss, ref, atol=LOSS_ATOL)


def test_fused_ce_leading_shape_flattened():
    logits, labels = _logits(n=32)
    flat = tce.fused_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 64)
    batched = tce.fused_cross_entropy(
        torch.from_numpy(logits).reshape(4, 8, -1),
        torch.from_numpy(labels).reshape(4, 8), 64)
    np.testing.assert_allclose(float(flat), float(batched), atol=1e-7)


@pytest.mark.parametrize("chunk", [512, 64])
def test_fused_linear_ce_matches_jax_fp32(chunk):
    """Head-folded loss and grads wrt hidden and weight against the JAX
    head-folded function (weight transposed) and its reference."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((48, 32)).astype(np.float32)
    w = (rng.standard_normal((512, 32)) * 0.1).astype(np.float32)  # [V, D]
    labels = rng.integers(0, 512, 48).astype(np.int32)
    labels[:3] = [0, chunk - 1, 511]
    tl = torch.from_numpy(labels)
    loss, (dh, dw) = _grad(
        lambda h_, w_: tce.fused_linear_cross_entropy(h_, w_, tl, chunk),
        h, w)
    jl = jnp.asarray(labels)
    for fn in (lambda h_, w_: jce.fused_linear_cross_entropy(h_, w_, jl,
                                                             chunk=chunk),
               lambda h_, w_: jce.reference_cross_entropy(h_ @ w_, jl)):
        jloss, (jdh, jdw) = jax.value_and_grad(fn, argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w.T))
        np.testing.assert_allclose(loss, float(jloss), atol=LOSS_ATOL)
        np.testing.assert_allclose(dh, np.asarray(jdh),
                                   atol=LINEAR_GRAD_ATOL)
        np.testing.assert_allclose(dw, np.asarray(jdw).T,
                                   atol=LINEAR_GRAD_ATOL)


def test_fused_linear_ce_bf16_gate():
    """bf16 hidden/weight at a multi-chunk vocab: grads in the primal
    dtypes, within 5 % relative norm of the JAX function's and of the fp32
    reference's, loss within 2 %."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal((128, 64)).astype(np.float32)
    w = (rng.standard_normal((8192, 64)) * 0.05).astype(np.float32)
    labels = rng.integers(0, 8192, 128).astype(np.int32)
    hb = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    loss = tce.fused_linear_cross_entropy(hb, wb, torch.from_numpy(labels))
    dh, dw = torch.autograd.grad(loss, (hb, wb))
    assert dh.dtype == dw.dtype == torch.bfloat16

    jh = jnp.asarray(h, jnp.bfloat16)
    jw = jnp.asarray(w.T, jnp.bfloat16)
    jl = jnp.asarray(labels)
    jloss, (jdh, jdw) = jax.value_and_grad(
        lambda a, b: jce.fused_linear_cross_entropy(a, b, jl),
        argnums=(0, 1))(jh, jw)
    h32, w32 = jh.astype(jnp.float32), jw.astype(jnp.float32)
    rloss, (rdh, rdw) = jax.value_and_grad(
        lambda a, b: jce.reference_cross_entropy(a @ b, jl),
        argnums=(0, 1))(h32, w32)
    for want in (float(jloss), float(rloss)):
        assert abs(float(loss.detach()) - want) / abs(want) < 2e-2
    for got, wants in ((dh, (jdh, rdh)), (dw, (jdw.T, rdw.T))):
        g = got.float().numpy()
        for want in wants:
            want = np.asarray(want, np.float32)
            assert (np.linalg.norm(g - want)
                    / (np.linalg.norm(want) + 1e-12)) < BF16_REL


def test_linear_lm_loss_folds_the_llama_head():
    """Pre-head hidden states of the flax Llama and of the port (same
    weights), then the head-folded next-token loss on each side: the
    port's ``return_hidden`` and head weight ``[V, D]`` give the JAX
    loss, and the loss of the port's own logits."""
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32)
    fmodel = jllama.Llama(jcfg)
    ids = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(np.int32)
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32)
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    jhidden = fmodel.apply(variables, jnp.asarray(ids), return_hidden=True)
    want = float(jce.linear_lm_loss(
        jhidden, variables["params"]["lm_head"]["kernel"], jnp.asarray(ids),
        chunk=128))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        hidden = model(tids, return_hidden=True)
        got = float(tce.linear_lm_loss(hidden, model.lm_head.weight, tids,
                                       chunk=128))
        logits = model(tids)
    assert hidden.shape == (2, 24, tcfg.d_model)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                               atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    plain = float(tce.reference_cross_entropy(logits[:, :-1], tids[:, 1:]))
    np.testing.assert_allclose(got, plain, atol=1e-5)
