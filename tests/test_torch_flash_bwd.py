"""The port's flash-attention residual and backward against the JAX
package's.

Inputs are drawn with numpy from a seed and handed to both sides. On the
CPU the port takes its plain versions (``reference_attention_lse``,
``flash_attention_bwd_reference``); the JAX side runs its Pallas kernels
(``_flash_kernel`` with the lse output, ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``) through the interpreter. The CUDA kernels are
held against the plain versions by tests/test_torch_kernels_cuda.py and
``chip_smoke.py`` on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.ops.attention import (  # noqa: E402
    _flash_attention_bwd_tpu,
    _flash_attention_tpu,
    _reference_attention,
)
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

# fp32 gradients: both sides accumulate in fp32 in different orders (the
# bound tests/test_models.py holds the Pallas backward to)
GRAD_ATOL = 2e-4
# lse rows of O(log s): fp32 logsumexp in two orders
LSE_ATOL = 1e-5
# bf16 primals: bf16 grads against the fp32 reference at bf16 resolution
# (tests/test_models.py::test_pallas_flash_bwd_bf16_grads)
BF16_ATOL = 6e-2


def _arrays(seed, b, s, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("s,sk,causal", [
    (256, 256, True), (256, 256, False), (256, 128, False)])
def test_plain_lse_matches_pallas_residual(s, sk, causal):
    b, h, d = 2, 2, 64
    q, k, v, _ = _arrays(0, b, s, sk, h, h, d)
    scale = d ** -0.5
    o, lse = tatt.reference_attention_lse(*_t(q, k, v), causal, scale)
    jo, jlse = _flash_attention_tpu(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal, scale,
                                    interpret=True, return_residuals=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    want = np.asarray(jlse)[..., 0].reshape(b, h, s)
    np.testing.assert_allclose(lse.numpy(), want, atol=LSE_ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-4)
    # flash_attention_fwd on CPU tensors: the same pair, or no lse
    o2, lse2 = tatt.flash_attention_fwd(*_t(q, k, v), causal, scale)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert tatt.flash_attention_fwd(*_t(q, k, v), causal, scale,
                                    want_lse=False)[1] is None


@pytest.mark.parametrize("s,sk,causal", [
    (128, 128, True), (128, 128, False), (256, 128, False), (384, 384, True)])
def test_plain_backward_matches_pallas_backward(s, sk, causal):
    """The plain backward, on the Pallas forward's own residuals, against
    the interpreted dq and dk/dv kernels: causal and full, more queries
    than keys (full), and s=384 (which the Pallas block picker splits into
    three 128-row blocks)."""
    b, h, d = 1, 2, 64
    q, k, v, g = _arrays(1, b, s, sk, h, h, d)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jo, jlse = _flash_attention_tpu(jq, jk, jv, causal, scale,
                                    interpret=True, return_residuals=True)
    want = _flash_attention_bwd_tpu(jq, jk, jv, jo, jlse, jg, causal, scale,
                                    interpret=True)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].reshape(b, h, s).copy())
    got = tatt.flash_attention_bwd(*_t(q, k, v), torch.from_numpy(
        np.asarray(jo).copy()), lse, torch.from_numpy(g), causal, scale)
    for name, x, y in zip("q k v".split(), got, want):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_gqa_matches_jax_vjp_through_repeat(causal):
    """torch.autograd through the port's flash_attention, K/V at kvh=2
    heads under h=4 query heads, against jax.vjp of the reference on
    jnp.repeat'ed K/V taken with respect to the unrepeated K/V: dk/dv sum
    over each group as jnp.repeat's VJP does."""
    b, s, h, kvh, d = 2, 96, 4, 2, 64
    q, k, v, g = _arrays(2, b, s, s, h, kvh, d)
    scale = d ** -0.5
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    rep = h // kvh

    def ref(q_, k_, v_):
        return _reference_attention(q_, jnp.repeat(k_, rep, axis=2),
                                    jnp.repeat(v_, rep, axis=2), causal,
                                    scale)

    jout, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4)
    for name, x, y in zip("q k v".split(), got, vjp(jnp.asarray(g))):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_bf16_grads_are_bf16_and_near_fp32_reference():
    b, s, h, kvh, d = 1, 128, 2, 1, 64
    q, k, v, g = _arrays(3, b, s, s, h, kvh, d)
    scale = d ** -0.5
    tq, tk, tv = (t.to(torch.bfloat16).requires_grad_()
                  for t in _t(q, k, v))
    out = tatt.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(g).to(torch.bfloat16))
    assert all(x.dtype == torch.bfloat16 for x in got)
    rep = h // kvh
    qf, kf, vf, gf = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                      for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda q_, k_, v_: _reference_attention(
        q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2), True,
        scale), jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf))
    for x, y in zip(got, vjp(jnp.asarray(gf))):
        np.testing.assert_allclose(x.float().numpy(), np.asarray(y),
                                   atol=BF16_ATOL)


def test_autograd_path_only_when_grad_is_recorded(monkeypatch):
    """Serving (no grad) asks the forward for no lse and builds no
    autograd node; training asks for it and saves the residuals."""
    calls = []
    real = tatt.flash_attention_fwd
    monkeypatch.setattr(tatt, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v, _ = _t(*_arrays(4, 1, 16, 16, 2, 2, 64))
    with torch.inference_mode():
        out = tatt.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None and calls == [{"want_lse": False}]
    calls.clear()
    out = tatt.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert calls == [{"want_lse": True}]
    assert [kern.launches for kern in tatt.KERNELS] == [0] * len(
        tatt.KERNELS)
