"""The rule the bf16 flash backward is held to on the card, tested here.

The tensor-core backward kernels (``csrc/flash_bwd_dq.cu``,
``csrc/flash_bwd_dkv.cu``) have the TPU kernels' MXU numerics: bf16
operands and fp32 sums, so the fp32 probabilities ``p`` and ``ds = p * (dp
- delta)`` are rounded to bf16 before the products that make dv, dk and dq.
Against the plain backward computed in fp32 on the same inputs, each
gradient x is held, element by element, to

    |x - bf16(ref)| <= 3e-5 + 2**-7 |ref| + 2**-8 T

with T from ``flash_attention_bwd_abs_terms``: ``|p|^T.|dO|`` for dv and
``scale * |ds|^T.|q|`` for dk (both summed over each GQA group), ``scale *
|ds|.|k|`` for dq (``chip_smoke.py``'s ``bwd_check``,
``tests/test_torch_kernels_cuda.py``'s ``_assert_bwd_close``). These tests
run that rule on a plain-PyTorch emulation of the kernels' numerics, tile
by tile: the emulation passes, two planted faults fail, and the rule
without its T term rejects the emulation. The terms are checked against the
JAX package's backward and against einsums; the JAX package's Pallas
backward on bf16 inputs, interpreted, passes the rule too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.ops.attention import (  # noqa: E402
    _flash_attention_bwd_tpu,
    _flash_attention_tpu,
    _reference_attention,
)
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

ATOL = 3e-5          # fp32 sums in another order, on values near zero
RTOL = 2.0 ** -7     # the two results on either side of a bf16 rounding
T_RTOL = 2.0 ** -8   # p and ds rounded to bf16 before their products
TILE = 64            # dkv's query rows and dq's keys per ring tile
DQ_BLOCK = 128       # dq's query rows per block

# (s, sk, h, kvh, d, causal): the forward gate's cases. GQA rep 1/4/8,
# causal and full, lengths off the kernels' 64- and 128-row tiles, sk > s,
# s > sk, d 64 and 128
CASES = [
    (1, 1, 2, 2, 64, True),
    (63, 63, 4, 4, 64, True),       # rep 1
    (129, 129, 8, 2, 64, True),     # rep 4
    (257, 257, 16, 2, 64, True),    # rep 8
    (200, 200, 8, 1, 128, False),   # rep 8, full
    (65, 300, 4, 1, 64, True),      # sk > s, causal (absolute positions)
    (300, 65, 8, 1, 64, False),     # s > sk, full
    (1, 129, 4, 4, 128, False),     # one query over a ragged key tail
]


def _inputs(seed, s, sk, h, kvh, d, b=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                          (b, s, h, d))]


def _case(case, seed):
    """bf16 q, k, v, dO; the forward's o (bf16) and lse from the plain
    version; the plain backward in fp32 and its T terms."""
    s, sk, h, kvh, d, causal = case
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(seed, s, sk, h, kvh, d))
    scale = d ** -0.5
    o, lse = tatt.reference_attention_lse(q.float(), k.float(), v.float(),
                                          causal, scale)
    args = (q, k, v, o.to(torch.bfloat16), lse, g, causal, scale)
    ref = tatt.flash_attention_bwd_reference(
        *(t.float() for t in args[:4]), lse, g.float(), causal, scale)
    return args, ref, tatt.flash_attention_bwd_abs_terms(*args)


def emulate_tc_backward(q, k, v, o, lse, g, causal, scale, round_ops=True,
                        fault=None):
    """The tensor-core kernels' arithmetic in plain PyTorch: p and ds in
    fp32 from the bf16 inputs, rounded to bf16 (unless ``round_ops`` is
    False); dk and dv summed in fp32 over 64-row query tiles, dq over
    64-key tiles; dk and dq scaled once at the end; outputs rounded to the
    inputs' type. ``fault`` plants a kernel fault: ``"dkv_last_q_tile"``
    skips the last query tile of dkv's scan, ``"dq_last_k_tile"`` ends each
    dq block's key loop one tile early."""
    s, sk, kvh = q.shape[1], k.shape[1], k.shape[2]
    p, ds, qf, kf, gf = tatt._bwd_probs(q, k, v, o, lse, g, causal, scale)
    if round_ops:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    qi = torch.arange(s)[:, None]
    kj = torch.arange(sk)[None, :]
    dkv_keep = torch.ones(s, sk, dtype=torch.bool)
    dq_keep = torch.ones(s, sk, dtype=torch.bool)
    if fault == "dkv_last_q_tile":
        dkv_keep &= qi < (s - 1) // TILE * TILE
    elif fault == "dq_last_k_tile":
        n_keys = (torch.clamp(qi // DQ_BLOCK * DQ_BLOCK + DQ_BLOCK, max=sk)
                  if causal else torch.full_like(qi, sk))
        dq_keep &= kj < (n_keys - 1) // TILE * TILE
    elif fault is not None:
        raise ValueError(fault)
    dk = torch.zeros(qf.shape[0], sk, *qf.shape[2:])
    dv = torch.zeros_like(dk)
    for q0 in range(0, s, TILE):
        rows = slice(q0, q0 + TILE)
        keep = dkv_keep[rows]
        dv += torch.einsum("bhqk,bqhd->bkhd",
                           torch.where(keep, p[:, :, rows], 0.0), gf[:, rows])
        dk += torch.einsum("bhqk,bqhd->bkhd",
                           torch.where(keep, ds[:, :, rows], 0.0), qf[:, rows])
    dq = torch.zeros_like(qf)
    for k0 in range(0, sk, TILE):
        keys = slice(k0, k0 + TILE)
        dq += torch.einsum("bhqk,bkhd->bqhd",
                           torch.where(dq_keep[:, keys], ds[..., keys], 0.0),
                           kf[:, keys])
    return ((dq * scale).to(q.dtype),
            tatt._group_sum(dk * scale, kvh).to(k.dtype),
            tatt._group_sum(dv, kvh).to(v.dtype))


def rule_excess(x, ref, term, t_rtol=T_RTOL):
    """Each value's distance from bf16(ref) less what the rule allows (all
    <= 0 when the gradient passes)."""
    want = ref.to(torch.bfloat16).float()
    return ((x.float() - want).abs()
            - (ATOL + RTOL * ref.abs() + t_rtol * term))


def _worst(got, ref, terms, t_rtol=T_RTOL):
    return [rule_excess(x, y, t, t_rtol).max().item()
            for x, y, t in zip(got, ref, terms)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_kernel_numerics_pass_the_backward_rule(case):
    args, ref, terms = _case(case, 0)
    got = emulate_tc_backward(*args)
    for x, t in zip(got, args[:3]):
        assert x.dtype == torch.bfloat16 and x.shape == t.shape
    assert max(_worst(got, ref, terms)) <= 0, _worst(got, ref, terms)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dkv_skipping_its_last_query_tile_fails_the_backward_rule(case):
    """The last 64-row query tile of dkv's scan left out, in every key
    block: dk or dv leaves the rule (at s = 1 only dv can: with one query
    and one key, ds is exactly 0)."""
    args, ref, terms = _case(case, 0)
    got = emulate_tc_backward(*args, fault="dkv_last_q_tile")
    assert max(_worst(got[1:], ref[1:], terms[1:])) > 0


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > 1], ids=str)
def test_dq_ending_one_key_tile_early_fails_the_backward_rule(case):
    """Each dq block's key loop ending one 64-key tile early. (With a
    single key, ds = p (dO.v - dO.o) is exactly 0, since o = v: dq is 0
    and no key-loop fault can show, so that case is not listed.)"""
    args, ref, terms = _case(case, 0)
    got = emulate_tc_backward(*args, fault="dq_last_k_tile")
    assert _worst(got[:1], ref[:1], terms[:1])[0] > 0


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_without_rounding_is_the_plain_backward(case):
    """With p and ds kept in fp32 the tiled emulation is the plain
    backward up to fp32 sum order, before and after rounding to bf16."""
    args, ref, _ = _case(case, 1)
    got = emulate_tc_backward(*args, round_ops=False)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y.to(torch.bfloat16), atol=ATOL,
                                   rtol=RTOL)


def test_rule_without_its_terms_rejects_the_kernel_numerics():
    """Rounding p and ds moves each gradient by more than one bf16 ulp of
    it, so the plain bf16 rule the CUDA-core kernels were held to cannot
    hold the tensor-core kernels; with the T terms it holds."""
    args, ref, terms = _case((512, 512, 4, 1, 64, True), 2)
    got = emulate_tc_backward(*args)
    assert max(_worst(got, ref, terms)) <= 0
    assert min(_worst(got, ref, terms, t_rtol=0.0)) > 0


@pytest.mark.parametrize("s,sk,h,kvh,causal", [
    (100, 100, 8, 8, True), (100, 100, 8, 2, True), (65, 130, 8, 1, False),
    (130, 65, 4, 2, False)])
def test_dv_term_is_the_jax_backward_with_abs_dO(s, sk, h, kvh, causal):
    """p >= 0, so |p|^T.|dO| is dv taken with |dO| as the output's
    gradient: the JAX package's reference attention differentiated by
    jax.vjp through jnp.repeat (which sums each GQA group)."""
    d = 64
    scale = d ** -0.5
    q, k, v, g = _inputs(3, s, sk, h, kvh, d)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tatt.reference_attention_lse(tq, tk, tv, causal, scale)
    t_dv = tatt.flash_attention_bwd_abs_terms(tq, tk, tv, o, lse, tg,
                                              causal, scale)[2]
    rep = h // kvh
    _, vjp = jax.vjp(lambda v_: _reference_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
        jnp.repeat(v_, rep, axis=2), causal, scale), jnp.asarray(v))
    (want,) = vjp(jnp.abs(jnp.asarray(g)))
    assert t_dv.shape == v.shape
    np.testing.assert_allclose(t_dv.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_dq_and_dk_terms_match_einsums(causal):
    """scale |ds|.|k| and scale |ds|^T.|q| (summed over each GQA group)
    against einsums over p and ds computed here in numpy."""
    b, s, sk, h, kvh, d = 2, 70, 90, 4, 2, 64
    scale = d ** -0.5
    q, k, v, g = _inputs(4, s, sk, h, kvh, d, b)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tatt.reference_attention_lse(tq, tk, tv, causal, scale)
    t_dq, t_dk, _ = tatt.flash_attention_bwd_abs_terms(tq, tk, tv, o, lse,
                                                       tg, causal, scale)
    rep = h // kvh
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q, kr) * scale
    if causal:
        sc = np.where(np.arange(s)[:, None] >= np.arange(sk)[None, :], sc,
                      -np.inf)
    p = np.exp(sc - lse.numpy()[..., None])
    delta = np.einsum("bqhd,bqhd->bhq", g, o.numpy())
    ds = p * (np.einsum("bqhd,bkhd->bhqk", g, vr) - delta[..., None])
    want_dq = np.einsum("bhqk,bkhd->bqhd", np.abs(ds), np.abs(kr)) * scale
    want_dk = (np.einsum("bhqk,bqhd->bkhd", np.abs(ds), np.abs(q)) * scale
               ).reshape(b, sk, kvh, rep, d).sum(3)
    np.testing.assert_allclose(t_dq.numpy(), want_dq, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(t_dk.numpy(), want_dk, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_pallas_backward_in_bf16_passes_the_backward_rule(causal):
    """The JAX package's Pallas backward kernels, interpreted, on bf16
    inputs with their forward's own residuals, against the port's plain
    backward in fp32 on the same inputs and residuals, under the same
    rule."""
    s, h, d = 256, 4, 64
    scale = d ** -0.5
    q, k, v, g = (jnp.asarray(x, jnp.bfloat16)
                  for x in _inputs(5, s, s, h, h, d, b=1))
    jo, jlse = _flash_attention_tpu(q, k, v, causal, scale, interpret=True,
                                    return_residuals=True)
    got = _flash_attention_bwd_tpu(q, k, v, jo, jlse, g, causal, scale,
                                   interpret=True)
    tq, tk, tv, to, tg = (torch.from_numpy(np.asarray(x, np.float32))
                          for x in (q, k, v, jo, g))
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].reshape(1, h, s).copy())
    ref = tatt.flash_attention_bwd_reference(tq, tk, tv, to, lse, tg, causal,
                                             scale)
    terms = tatt.flash_attention_bwd_abs_terms(tq, tk, tv, to, lse, tg,
                                               causal, scale)
    assert all(x.dtype == jnp.bfloat16 for x in got)
    got = [torch.from_numpy(np.asarray(x, np.float32)) for x in got]
    assert max(_worst(got, ref, terms)) <= 0, _worst(got, ref, terms)
