"""The rule the bf16 flash forward is held to on the card, tested here.

The tensor-core kernel (``csrc/flash_fwd.cu``) has the TPU kernel's MXU
numerics: bf16 operands, fp32 sums, and each probability rounded to bf16
for the P.V product, while the row sum ``l`` comes from the unrounded
probabilities. Against the plain version computed in fp32 on the same
inputs it is held, element by element, to

    |out - bf16(ref)| <= 3e-5 + 2**-7 |ref| + 2**-8 (P.|V|)

(``chip_smoke.py``'s ``flash_check``, ``tests/test_torch_kernels_cuda.py``'s
``_assert_flash_close``). These tests run that rule on a plain-PyTorch
emulation of the kernel's numerics, tile by tile with its online softmax:
the emulation passes, a variant that drops one 64-key tile fails, and the
rule without its P.|V| term is too tight for it. ``P.|V|`` comes from the
port's ``reference_attention_abs_v``, held against the JAX package's
reference; the JAX package's Pallas kernel, interpreted, passes the rule
too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.ops.attention import (  # noqa: E402
    _flash_attention_tpu,
    _reference_attention,
)
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

ATOL = 3e-5          # fp32 sums in another order, on values near zero
RTOL = 2.0 ** -7     # the two results on either side of a bf16 rounding
PV_RTOL = 2.0 ** -8  # each probability rounded to bf16 before P.V
KEY_TILE = 128       # the kernel's keys per K/V tile

# (s, sk, h, kvh, d, causal): GQA rep 1/4/8, causal and full, lengths off
# the kernel's 128-row tiles and its warpgroups' 64 rows, sk > s, s > sk
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


def _qkv(seed, s, sk, h, kvh, d, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    return q, k, v


def _bf16(*xs):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def emulate_tc_kernel(q, k, v, causal, scale, round_p=True, drop=None):
    """The tensor-core kernel's arithmetic in plain PyTorch: fp32 scores of
    the bf16 inputs scaled after the product, tiles of 128 keys with a
    running max, ``l`` summed from the fp32 probabilities, P rounded to
    bf16 (unless ``round_p`` is False) for an fp32-accumulated P.V, the
    output rounded to q's type. ``drop`` names a 64-key tile (keys
    64*drop .. 64*drop + 63) that is left out, as a faulty kernel would."""
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    qi = torch.arange(s)[:, None]
    for k0 in range(0, sk, KEY_TILE):
        k1 = min(k0 + KEY_TILE, sk)
        kj = torch.arange(k0, k1)[None, :]
        keep = torch.ones(s, k1 - k0, dtype=torch.bool)
        if causal:
            keep &= kj <= qi
        if drop is not None:
            keep &= kj // 64 != drop
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        sc = torch.where(keep, sc, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(keep, torch.exp(sc - m_new), torch.zeros_like(sc))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pr = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * alpha + pr @ vf[:, :, k0:k1]
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def rule_excess(out, ref, pv, pv_rtol=PV_RTOL):
    """Each value's distance from bf16(ref) less what the rule allows
    (all <= 0 when the output passes)."""
    want = ref.to(torch.bfloat16).float()
    return ((out.float() - want).abs()
            - (ATOL + RTOL * ref.abs() + pv_rtol * pv))


def _case(case, seed):
    s, sk, h, kvh, d, causal = case
    q, k, v = _bf16(*_qkv(seed, s, sk, h, kvh, d))
    scale = d ** -0.5
    ref = tatt.reference_attention(q.float(), k.float(), v.float(), causal,
                                   scale)
    pv = tatt.reference_attention_abs_v(q, k, v, causal, scale)
    return q, k, v, causal, scale, ref, pv


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_kernel_numerics_pass_the_flash_rule(case):
    q, k, v, causal, scale, ref, pv = _case(case, 0)
    out = emulate_tc_kernel(q, k, v, causal, scale)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    excess = rule_excess(out, ref, pv)
    assert excess.max().item() <= 0, excess.max().item()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_dropping_a_64_key_tile_fails_the_flash_rule(case):
    """The last 64-key tile any row sees (the fault of a kernel that ends
    its key loop one tile early) is left out."""
    q, k, v, causal, scale, ref, pv = _case(case, 0)
    s, sk = q.shape[1], k.shape[1]
    seen = min(s, sk) if causal else sk
    out = emulate_tc_kernel(q, k, v, causal, scale, drop=(seen - 1) // 64)
    assert rule_excess(out, ref, pv).max().item() > 0


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_without_rounding_p_is_the_plain_version(case):
    """With P kept in fp32 the emulation's online softmax is the plain
    version up to fp32 sum order, before and after rounding to bf16."""
    q, k, v, causal, scale, ref, _ = _case(case, 1)
    out = emulate_tc_kernel(q, k, v, causal, scale, round_p=False)
    torch.testing.assert_close(out, ref.to(torch.bfloat16), atol=ATOL,
                               rtol=RTOL)


def test_rule_without_the_pv_term_rejects_the_kernel_numerics():
    """Long rows (outputs of ~0.05, P.|V| of ~0.8): rounding P moves the
    output by more than one bf16 ulp of it, so the all-fp32 rule the
    CUDA-core kernel was held to cannot hold the tensor-core kernel."""
    q, k, v, causal, scale, ref, pv = _case((512, 512, 4, 1, 64, True), 2)
    out = emulate_tc_kernel(q, k, v, causal, scale)
    assert rule_excess(out, ref, pv).max().item() <= 0
    assert rule_excess(out, ref, pv, pv_rtol=0.0).max().item() > 0


@pytest.mark.parametrize("s,sk,h,kvh,causal", [
    (100, 100, 8, 8, True), (100, 100, 8, 2, True), (65, 130, 8, 1, False),
    (130, 65, 4, 2, False)])
def test_pv_abs_matches_jax_reference(s, sk, h, kvh, causal):
    """``reference_attention_abs_v`` is the JAX package's reference
    attention in fp32 with |V| in place of V (K/V repeated as jnp.repeat
    does)."""
    d = 64
    q, k, v = _qkv(3, s, sk, h, kvh, d)
    ours = tatt.reference_attention_abs_v(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, d ** -0.5).numpy()
    rep = h // kvh
    jk = jnp.repeat(jnp.asarray(k), rep, axis=2)
    jv = jnp.repeat(jnp.abs(jnp.asarray(v)), rep, axis=2)
    ref = np.asarray(_reference_attention(jnp.asarray(q), jk, jv, causal,
                                          d ** -0.5))
    assert ours.shape == q.shape and (ours >= 0).all()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_pallas_kernel_in_bf16_passes_the_flash_rule(causal):
    """The JAX package's Pallas flash kernel, interpreted, on bf16 inputs
    (K/V repeated to the query heads) against the port's plain version in
    fp32, under the same rule."""
    s, h, kvh, d = 256, 4, 1, 64
    q, k, v = _qkv(4, s, s, h, kvh, d)
    tq, tk, tv = _bf16(q, k, v)
    scale = d ** -0.5
    rep = h // kvh
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    kernel = _flash_attention_tpu(jq, jnp.repeat(jk, rep, axis=2),
                                  jnp.repeat(jv, rep, axis=2), causal, scale,
                                  interpret=True)
    out = torch.from_numpy(np.asarray(kernel, np.float32))
    ref = tatt.reference_attention(tq.float(), tk.float(), tv.float(),
                                   causal, scale)
    pv = tatt.reference_attention_abs_v(tq, tk, tv, causal, scale)
    assert rule_excess(out, ref, pv).max().item() <= 0
