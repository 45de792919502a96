"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

pytestmark = pytest.mark.cuda

# kernel vs plain version in fp32 on the same inputs, rounded to the
# kernel's output type: (atol, rtol). fp32 kernels: sums in another order.
# bf16 kernels compute in fp32 and round once: one bf16 ulp (at most 2**-7
# of the value) where the two results straddle a rounding boundary, plus
# fp32 sum-order noise on values near zero
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-5, 2.0 ** -7)}


# gradients (values up to ~10 at d=128) in fp32: sums of a few thousand
# terms in another order; the bound tests/test_models.py holds the Pallas
# backward to. bf16: as TOL, plus BWD_T_RTOL's term.
BWD_TOL = {torch.float32: (2e-4, 1e-5), torch.bfloat16: TOL[torch.bfloat16]}
# the bf16 backward kernels run on the tensor cores with the TPU kernels'
# MXU numerics: p and ds are rounded to bf16 before the products that make
# dv, dk and dq, which moves each gradient by at most 2**-8 T, T from
# flash_attention_bwd_abs_terms (tests/test_torch_flash_bwd_gate.py)
BWD_T_RTOL = 2.0 ** -8
# lse rows of O(log s), fp32 in both dtypes: sum order and q pre-scaling
LSE_ATOL = 1e-4
# the bf16 flash forward runs on the tensor cores with the TPU kernel's MXU
# numerics: it also rounds each probability to bf16 for P.V, which moves
# output i by at most 2**-8 (P.|V|)_i on top of TOL's terms
FLASH_PV_RTOL = 2.0 ** -8


def _assert_kernel_close(out, ref, dtype, tol=TOL):
    atol, rtol = tol[dtype]
    torch.testing.assert_close(out.float(), ref.to(dtype).float(),
                               atol=atol, rtol=rtol)


def _assert_flash_close(out, q, k, v, causal, ref):
    """The flash forward's output against the plain version in fp32 on the
    same inputs: TOL for fp32; for bf16 |out - bf16(ref)| <= 3e-5 +
    2**-7 |ref| + 2**-8 (P.|V|), element by element."""
    if out.dtype == torch.float32:
        _assert_kernel_close(out, ref, out.dtype)
        return
    atol, rtol = TOL[torch.bfloat16]
    pv = tatt.reference_attention_abs_v(q, k, v, causal, q.shape[-1] ** -0.5)
    excess = ((out.float() - ref.to(torch.bfloat16).float()).abs()
              - (atol + rtol * ref.abs() + FLASH_PV_RTOL * pv))
    assert torch.isfinite(out).all()
    assert excess.max().item() <= 0, (
        f"{int((excess > 0).sum())} values outside the bf16 flash rule, "
        f"worst by {excess.max().item():.3e}")


def _assert_bwd_close(got, want, terms, dtype):
    """dq, dk, dv against the plain backward in fp32: BWD_TOL for fp32; for
    bf16 |x - bf16(ref)| <= 3e-5 + 2**-7 |ref| + 2**-8 T, element by
    element."""
    for name, x, y, t in zip("q k v".split(), got, want, terms):
        assert torch.isfinite(x).all(), name
        if dtype == torch.float32:
            _assert_kernel_close(x, y, dtype, BWD_TOL)
            continue
        atol, rtol = BWD_TOL[dtype]
        excess = ((x.float() - y.to(dtype).float()).abs()
                  - (atol + rtol * y.abs() + BWD_T_RTOL * t))
        assert excess.max().item() <= 0, (
            f"d{name}: {int((excess > 0).sum())} values outside the bf16 "
            f"backward rule, worst by {excess.max().item():.3e}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,h,kvh,d,causal", [
    (100, 100, 8, 2, 64, True),     # ragged tail, GQA 4
    (64, 200, 4, 4, 128, False),    # more keys than queries, full
    (257, 257, 32, 8, 128, True),   # the slice's heads, ragged
    (1, 1, 2, 1, 64, True),
    # the bf16 kernel's edges: 128-row query and key tiles, 64 rows a
    # warpgroup; lengths off the tiles, sk > s and s > sk, rep 1/4/8
    (63, 63, 8, 8, 128, True),      # one warpgroup's rows only, rep 1
    (65, 65, 8, 2, 64, True),       # the second warpgroup's first row
    (129, 129, 16, 2, 128, True),   # one row past a tile, rep 8
    (1000, 1000, 8, 1, 128, True),  # eight tiles, ragged, rep 8
    (1, 129, 8, 8, 64, False),      # one query over a ragged key tail
    (63, 129, 4, 1, 64, False),     # sk > s, full, rep 4
    (129, 65, 8, 1, 128, False),    # s > sk, full, rep 8
    (65, 1000, 4, 4, 128, True),    # sk > s, causal (absolute positions)
    (1000, 63, 4, 1, 64, True),     # s > sk, causal, rep 4
])
def test_flash_kernel_matches_plain(cuda, dtype, s, sk, h, kvh, d, causal):
    gen = np.random.default_rng(s + sk + d)
    q = _randn(gen, 2, s, h, d).to(cuda, dtype)
    k = _randn(gen, 2, sk, kvh, d).to(cuda, dtype)
    v = _randn(gen, 2, sk, kvh, d).to(cuda, dtype)
    before = tatt.FLASH_FWD.launches
    out = tatt.flash_attention(q, k, v, causal=causal)
    ref = tatt.reference_attention(q.float(), k.float(), v.float(), causal,
                                   d ** -0.5)
    torch.cuda.synchronize()
    assert tatt.FLASH_FWD.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _assert_flash_close(out, q, k, v, causal, ref)


FLASH_SHAPES = [
    (100, 100, 8, 2, 64, True),     # ragged tail, GQA 4
    (64, 200, 4, 4, 128, False),    # more keys than queries, full
    (200, 64, 4, 2, 64, False),     # more queries than keys, full
    (257, 257, 32, 8, 128, True),   # the slice's heads, ragged
    (1, 1, 2, 1, 64, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,h,kvh,d,causal", FLASH_SHAPES)
def test_flash_lse_matches_plain(cuda, dtype, s, sk, h, kvh, d, causal):
    gen = np.random.default_rng(s + 2 * sk + d)
    q = _randn(gen, 2, s, h, d).to(cuda, dtype)
    k = _randn(gen, 2, sk, kvh, d).to(cuda, dtype)
    v = _randn(gen, 2, sk, kvh, d).to(cuda, dtype)
    out, lse = tatt.flash_attention_fwd(q, k, v, causal, d ** -0.5)
    ref, ref_lse = tatt.reference_attention_lse(q.float(), k.float(),
                                                v.float(), causal, d ** -0.5)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (2, h, s)
    _assert_flash_close(out, q, k, v, causal, ref)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


# the backward's shapes: the forward's, and the bf16 kernels' edges (64-
# and 128-row tiles; dkv's blocks of 128 keys, dq's of 128 query rows),
# lengths off the tiles, sk > s and s > sk, GQA rep 1/4/8
BWD_SHAPES = FLASH_SHAPES + [
    (63, 63, 4, 4, 64, True),       # rep 1
    (129, 129, 8, 2, 64, True),     # rep 4, one row past a tile
    (257, 257, 16, 2, 128, True),   # rep 8
    (200, 200, 8, 1, 128, False),   # rep 8, full
    (65, 300, 4, 1, 64, True),      # sk > s, causal (absolute positions)
    (300, 65, 8, 1, 64, False),     # s > sk, full
    (1, 129, 4, 4, 128, False),     # one query over a ragged key tail
    (1000, 1000, 8, 2, 128, True),  # many tiles, ragged
]


def _bwd_inputs(cuda, dtype, seed, s, sk, h, kvh, d, causal):
    """q, k, v, o, lse, dO on the card (o rounded to ``dtype``, so the
    kernels and the plain backward take delta from the same o)."""
    gen = np.random.default_rng(seed)
    q = _randn(gen, 2, s, h, d).to(cuda, dtype)
    k = _randn(gen, 2, sk, kvh, d).to(cuda, dtype)
    v = _randn(gen, 2, sk, kvh, d).to(cuda, dtype)
    g = _randn(gen, 2, s, h, d).to(cuda, dtype)
    o, lse = tatt.reference_attention_lse(q.float(), k.float(), v.float(),
                                          causal, d ** -0.5)
    return q, k, v, o.to(dtype), lse, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,h,kvh,d,causal", BWD_SHAPES)
def test_flash_backward_kernels_match_plain(cuda, dtype, s, sk, h, kvh, d,
                                            causal):
    """dq, dk, dv from the two backward kernels against the plain backward
    in fp32 on the same inputs and residuals; dk/dv at kvh heads. fp32 is
    held to BWD_TOL, bf16 to the backward rule."""
    scale = d ** -0.5
    q, k, v, o, lse, g = _bwd_inputs(cuda, dtype, 3 * s + sk + d, s, sk, h,
                                     kvh, d, causal)
    before = (tatt.FLASH_BWD_DQ.launches, tatt.FLASH_BWD_DKV.launches)
    got = tatt.flash_attention_bwd(q, k, v, o, lse, g, causal, scale)
    want = tatt.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, g.float(), causal,
        scale)
    terms = tatt.flash_attention_bwd_abs_terms(q, k, v, o, lse, g, causal,
                                               scale)
    torch.cuda.synchronize()
    assert (tatt.FLASH_BWD_DQ.launches, tatt.FLASH_BWD_DKV.launches) == (
        before[0] + 1, before[1] + 1)
    for name, x, t in zip("q k v".split(), got, (q, k, v)):
        assert x.dtype == dtype and x.shape == t.shape, name
    _assert_bwd_close(got, want, terms, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """dq, dk and dv are bit-identical over two launches on the same
    inputs: no atomics, each output row written once by its own block."""
    s, h, kvh, d = 515, 16, 2, 128
    q, k, v, o, lse, g = _bwd_inputs(cuda, dtype, 21, s, s, h, kvh, d, True)
    first = tatt.flash_attention_bwd(q, k, v, o, lse, g, True, d ** -0.5)
    second = tatt.flash_attention_bwd(q, k, v, o, lse, g, True, d ** -0.5)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_flash_backward_raises_on_misaligned_views(cuda):
    """The bf16 backward kernels read q, k, v and dO and write dq, dk, dv
    through TMA: a view 2 bytes past an aligned address raises before any
    launch."""
    buf = torch.zeros(1 + 2 * 8 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    bad = buf[1:1 + 8 * 4 * 64].view(1, 8, 4, 64)
    good = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8, device=cuda)
    assert bad.is_contiguous()
    before = (tatt.FLASH_BWD_DQ.launches, tatt.FLASH_BWD_DKV.launches)
    for i in range(4):
        args = [good] * 4
        args[i] = bad
        q, k, v, g = args
        with pytest.raises(ValueError, match="aligned"):
            tatt.flash_bwd_dq(q, k, v, g, lse, lse, True, 0.125)
        with pytest.raises(ValueError, match="aligned"):
            tatt.flash_bwd_dkv(q, k, v, g, lse, lse, True, 0.125)
    assert (tatt.FLASH_BWD_DQ.launches, tatt.FLASH_BWD_DKV.launches) == before


def test_flash_autograd_round_trip_matches_cpu(cuda):
    """torch.autograd through flash_attention on the card (forward with
    lse, then both backward kernels) against the same call on the CPU
    (the plain versions), fp32, GQA."""
    gen = np.random.default_rng(7)
    cpu = [_randn(gen, 2, 130, 8, 64), _randn(gen, 2, 130, 2, 64),
           _randn(gen, 2, 130, 2, 64)]
    g = _randn(gen, 2, 130, 8, 64)

    def grads(ts, g_):
        ts = [t.clone().requires_grad_() for t in ts]
        out = tatt.flash_attention(*ts, causal=True)
        return [out.detach()] + list(torch.autograd.grad(out, ts, g_))

    tatt.reset_launch_counts()
    on_card = grads([t.to(cuda) for t in cpu], g.to(cuda))
    torch.cuda.synchronize()
    assert [k.launches for k in tatt.KERNELS] == [1, 1, 1, 0, 0]
    for x, y in zip(on_card, grads(cpu, g)):
        torch.testing.assert_close(x.cpu(), y, atol=2e-4, rtol=1e-5)


def test_train_step_on_card_matches_cpu(cuda):
    """Two fp32 steps of a small Llama (head_dim 64) with remat on the
    card, through all three flash kernels, against the same steps on the
    CPU; launches per step: 2 forwards (one is remat's recompute), one dq
    and one dkv per layer."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_llama,
        llama_tiny,
        make_lm_train_step,
        policy,
    )

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 96)))
    step = make_lm_train_step(remat=True, precision=policy("fp32"),
                              chunk=128)

    def run(device):
        model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
        model = model.to(device)
        state = TrainState(model, adamw(model.parameters(), 1e-3, 0.1))
        return [float(step(state, {"input_ids": b})[1]) for b in ids]

    tatt.reset_launch_counts()
    on_card = run(cuda)
    n = cfg.num_layers * len(ids)
    assert [k.launches for k in tatt.KERNELS] == [2 * n, n, n, 0, 0]
    np.testing.assert_allclose(on_card, run("cpu"), rtol=1e-5)


def _paged(gen, b, h, kvh, d, bs, seq_lens):
    mb = max(-(-n // bs) for n in seq_lens) + 1
    need = [-(-n // bs) for n in seq_lens]
    num_pages = 1 + sum(need) + 3
    order = gen.permutation(np.arange(1, num_pages)).tolist()
    tables = np.zeros((b, mb), np.int32)
    for i, n in enumerate(need):
        tables[i, :n] = [order.pop() for _ in range(n)]
    q = _randn(gen, b, h, d)
    kp = _randn(gen, num_pages, bs, kvh, d)
    vp = _randn(gen, num_pages, bs, kvh, d)
    kp[0] = 0
    vp[0] = 0
    return q, kp, vp, torch.from_numpy(tables), torch.tensor(
        seq_lens, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,seq_lens", [
    (32, 8, 128, 16, [17, 2048, 1, 300, 16, 33, 1000, 5]),  # the slice
    (4, 2, 128, 8, [5, 11, 32]),      # tests/test_serving.py's shapes
    (8, 8, 64, 8, [9, 64]),           # MHA
    (16, 2, 64, 24, [100, 47]),       # 8 heads per KV head, pages of 24
])
def test_paged_decode_kernel_matches_plain(cuda, dtype, h, kvh, d, bs,
                                           seq_lens):
    """The kernel runs on pools whose null page holds NaN (it must never
    read it); the plain version, which gathers every table entry, on the
    same pools with the null page zeroed."""
    gen = np.random.default_rng(len(seq_lens) + h)
    q, kp, vp, bt, sl = _paged(gen, len(seq_lens), h, kvh, d, bs, seq_lens)
    q, kp, vp = (t.to(cuda, dtype) for t in (q, kp, vp))
    bt, sl = bt.to(cuda), sl.to(cuda)
    ref = tatt.paged_decode_reference(q.float(), kp.float(), vp.float(), bt,
                                      sl, d ** -0.5)
    kp[0] = float("nan")
    vp[0] = float("nan")
    before = tatt.PAGED_DECODE.launches
    out = tatt.paged_decode_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert tatt.PAGED_DECODE.launches == before + 1
    assert torch.isfinite(out).all()
    _assert_kernel_close(out, ref, dtype)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)  # head_dim 32
    with pytest.raises(ValueError, match="head_dim"):
        tatt.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tatt.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 8, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(TypeError, match="one type"):
        tatt.flash_attention(q, q.bfloat16(), q.bfloat16())
    # contiguous, but 2 bytes past an aligned address: TMA cannot read it
    buf = torch.zeros(1 + 8 * 4 * 64, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 4, 64)
    assert q.is_contiguous()
    before = tatt.FLASH_FWD.launches
    with pytest.raises(ValueError, match="aligned"):
        tatt.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="aligned"):
        tatt.flash_attention(buf[:-1].view(1, 8, 4, 64), q, q)
    assert tatt.FLASH_FWD.launches == before
    with pytest.raises(ValueError, match="lse"):
        tatt.flash_attention_bwd(q, q, q, q, torch.zeros(1, 4, 8,
                                                         device=cuda,
                                                         dtype=torch.bfloat16),
                                 q, True, 0.125)
    pages = torch.zeros(3, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tatt.paged_decode_attention(
            torch.zeros(1, 4, 64, device=cuda), pages, pages,
            torch.zeros(1, 2, dtype=torch.int64, device=cuda),
            torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.paged_decode_attention(
            torch.zeros(1, 4, 64, device=cuda), pages, pages,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))


def _paged_int8(gen, b, h, kvh, d, bs, seq_lens, mb=None):
    """int8 pools quantized from random rows by ``quantize_kv_rows``, with
    disjoint page runs per sequence (page 0 is the null page); CPU."""
    need = [-(-n // bs) for n in seq_lens]
    mb = mb or max(need)
    num_pages = 1 + sum(need) + 2
    order = gen.permutation(np.arange(1, num_pages)).tolist()
    tables = np.zeros((b, mb), np.int32)
    for i, n in enumerate(need):
        tables[i, :n] = [order.pop() for _ in range(n)]
    k8, ks = tatt.quantize_kv_rows(_randn(gen, num_pages, bs, kvh, d))
    v8, vs = tatt.quantize_kv_rows(_randn(gen, num_pages, bs, kvh, d))
    return (_randn(gen, b, h, d), k8, v8, ks, vs, torch.from_numpy(tables),
            torch.tensor(seq_lens, dtype=torch.int32))


def _poison_null_page(k8, v8, ks, vs):
    """What the kernel must never read: rows of +-127, NaN scales."""
    sign = torch.where(torch.arange(k8.shape[-1]) % 2 == 0, 127, -127)
    k8[0] = sign.to(k8.dtype)
    v8[0] = (-sign).to(v8.dtype)
    ks[0] = float("nan")
    vs[0] = float("nan")


def _int8_ref(q, k8, v8, ks, vs, bt, sl):
    """The plain int8 version in fp32 on a copy whose null page is zeroed
    (0 * NaN would be NaN in its fold)."""
    k8, v8, ks, vs = (t.clone() for t in (k8, v8, ks, vs))
    for t in (k8, v8, ks, vs):
        t[0] = 0
    return tatt.paged_decode_int8_reference(q.float(), k8, v8, ks, vs, bt,
                                            sl, q.shape[-1] ** -0.5)


def _int8_launch(q, k8, v8, ks, vs, bt, sl):
    before = tatt.PAGED_DECODE_INT8.launches
    out = tatt.paged_decode_attention(q, k8, v8, bt, sl, k_scale=ks,
                                      v_scale=vs)
    torch.cuda.synchronize()
    assert tatt.PAGED_DECODE_INT8.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    return out


# int8 kernel with an fp32 query vs the plain version in fp32: the same
# fold, sums in another order (the bound the JAX tests hold the Pallas
# int8 kernel to); a bf16 query is held as the other bf16 kernels (TOL)
INT8_FP32_ATOL = 2e-5


def _assert_int8_close(out, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=INT8_FP32_ATOL, rtol=0)
    else:
        _assert_kernel_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_int8_kernel_matches_plain(cuda, dtype, d, rep, bs):
    """Lengths 1, block_size - 1, block_size + 1, a run of 2.5 pages and a
    full table row (4 pages); the null page holds +-127 rows and NaN
    scales, which the kernel must never read."""
    gen = np.random.default_rng(d + 10 * rep + bs)
    kvh = 2
    seq_lens = [1, bs - 1, bs + 1, 5 * bs // 2, 4 * bs]
    q, k8, v8, ks, vs, bt, sl = _paged_int8(gen, len(seq_lens), kvh * rep,
                                            kvh, d, bs, seq_lens, mb=4)
    q = q.to(dtype)
    ref = _int8_ref(q, k8, v8, ks, vs, bt, sl)
    _poison_null_page(k8, v8, ks, vs)
    out = _int8_launch(*(t.to(cuda) for t in (q, k8, v8, ks, vs, bt, sl)))
    _assert_int8_close(out, ref.to(cuda), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_int8_kernel_slice_shape(cuda, dtype):
    """The slice's heads (32 over 8 KV heads, d 128, pages of 16) at long
    and ragged lengths."""
    gen = np.random.default_rng(11)
    seq_lens = [17, 2048, 1, 300, 16, 33, 1000, 5]
    args = _paged_int8(gen, 8, 32, 8, 128, 16, seq_lens)
    q = args[0].to(dtype)
    ref = _int8_ref(q, *args[1:])
    _poison_null_page(*args[1:5])
    out = _int8_launch(*(t.to(cuda) for t in (q, *args[1:])))
    _assert_int8_close(out, ref.to(cuda), dtype)


def test_paged_decode_int8_kernel_shared_and_cow_pages(cuda):
    """Rows sharing prefix pages, and a row reading a COW copy
    (``kvcache.copy_page``) of another's page, against the plain version;
    identical context gives identical bits."""
    from move2kube_tpu_torch.serving import kvcache as tkv

    gen = np.random.default_rng(12)
    cfg = tkv.KVCacheConfig(num_layers=1, num_kv_heads=2, head_dim=128,
                            block_size=16, num_pages=8, max_batch=4,
                            max_pages_per_seq=3, dtype=torch.int8)
    cache = tkv.init_cache(cfg, cuda)
    for key in ("k", "v"):
        q8, sc = tatt.quantize_kv_rows(_randn(gen, 7, 16, 2, 128).to(cuda))
        cache[key][0][1:] = q8
        cache[key + "_scale"][0][1:] = sc
    tkv.copy_page(cache, 2, 6)
    pools = [cache[key][0] for key in tkv.PAGE_KEYS]
    q = _randn(gen, 1, 8, 128).expand(4, 8, 128).contiguous().to(cuda)
    bt = torch.tensor([[1, 2, 3], [1, 2, 4], [1, 6, 0], [1, 2, 0]],
                      dtype=torch.int32, device=cuda)
    sl = torch.tensor([40, 35, 32, 32], dtype=torch.int32, device=cuda)
    ref = _int8_ref(q, *pools, bt, sl)
    _poison_null_page(*pools)
    out = _int8_launch(q, *pools, bt, sl)
    _assert_int8_close(out, ref, torch.float32)
    assert torch.equal(out[2], out[3])  # page 6 is a copy of page 2


def _split_tokens(b, kvh, mb, bs):
    """The tokens of one split the wrappers plan on this card."""
    pps, _ = tatt.paged_split_plan(
        b, kvh, mb, bs, tatt._sm_count(torch.cuda.current_device()))
    return pps * bs


def _poisoned_paged(gen, quant, b, h, kvh, d, bs, seq_lens, mb):
    """Pools (fp32, or int8 from ``quantize_kv_rows``) with disjoint page
    runs; every table entry past a sequence's end points at the null page
    or at a page no sequence owns, and those pages hold NaN (int8: +-127
    rows, NaN scales), as do the rows past each sequence's length in its
    last page. Returns (q, pools, tables, seq_lens) poisoned on the CPU and
    the pools as they were before, for the plain version."""
    need = [-(-n // bs) for n in seq_lens]
    num_pages = 1 + sum(need) + 4
    order = gen.permutation(np.arange(1, num_pages)).tolist()
    tables = np.zeros((b, mb), np.int32)
    for i, n in enumerate(need):
        tables[i, :n] = [order.pop() for _ in range(n)]
    unowned = [0, *order]
    for i, n in enumerate(need):
        tables[i, n:] = gen.choice(unowned, size=mb - n)
    if quant:
        pools = [*tatt.quantize_kv_rows(_randn(gen, num_pages, bs, kvh, d)),
                 *tatt.quantize_kv_rows(_randn(gen, num_pages, bs, kvh, d))]
        pools = [pools[0], pools[2], pools[1], pools[3]]  # k8, v8, ks, vs
    else:
        pools = [_randn(gen, num_pages, bs, kvh, d) for _ in range(2)]
    clean = [t.clone() for t in pools]
    for t in clean:
        t[unowned] = 0
    sign = torch.where(torch.arange(d) % 2 == 0, 127, -127).to(torch.int8)
    tails = [(int(tables[i, n // bs]), n % bs)
             for i, n in enumerate(seq_lens) if n % bs]

    def poison(idx):
        if quant:
            pools[0][idx] = sign
            pools[1][idx] = -sign
            pools[2][idx] = float("nan")
            pools[3][idx] = float("nan")
        else:
            for t in pools:
                t[idx] = float("nan")

    poison(unowned)
    for page, row in tails:
        poison((page, slice(row, None)))
    q = _randn(gen, b, h, d)
    return (q, pools, torch.from_numpy(tables),
            torch.tensor(seq_lens, dtype=torch.int32), clean)


def _split_launch(cuda, quant, dtype, q, pools, bt, sl, clean):
    """The kernel twice on the poisoned pools (the same bits both times),
    held against the plain version on the clean ones."""
    q = q.to(cuda, dtype)
    bt, sl = bt.to(cuda), sl.to(cuda)
    if quant:
        pools = [t.to(cuda) for t in pools]
        ref = tatt.paged_decode_int8_reference(
            q.float(), *(t.to(cuda) for t in clean), bt, sl,
            q.shape[-1] ** -0.5)
        outs = [_int8_launch(q, *pools, bt, sl) for _ in range(2)]
        _assert_int8_close(outs[0], ref, dtype)
    else:
        pools = [t.to(cuda, dtype) for t in pools]
        ref = tatt.paged_decode_reference(
            q.float(), *(t.to(cuda, dtype).float() for t in clean), bt, sl,
            q.shape[-1] ** -0.5)
        before = tatt.PAGED_DECODE.launches
        outs = [tatt.paged_decode_attention(q, *pools, bt, sl)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert tatt.PAGED_DECODE.launches == before + 2
        assert torch.isfinite(outs[0]).all()
        _assert_kernel_close(outs[0], ref, dtype)
    assert torch.equal(outs[0], outs[1]), "not bit-identical over launches"


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,bs,mb", [
    (32, 8, 128, 16, 37),  # the slice's heads
    (16, 2, 64, 8, 45),    # 8 heads per KV head, pages of 8
])
def test_paged_split_edges(cuda, quant, dtype, h, kvh, d, bs, mb):
    """Lengths one short of a split, at a split, one past it, 1, two splits
    and one past, and the whole table, whose page count is not a multiple
    of the pages a split; NaN past every sequence's end."""
    b = 7
    sp = _split_tokens(b, kvh, mb, bs)
    assert mb % (sp // bs) and mb * bs > 2 * sp + 1
    seq_lens = [sp - 1, sp, sp + 1, 1, 2 * sp, 2 * sp + 1, mb * bs]
    gen = np.random.default_rng(mb + d + quant)
    _split_launch(cuda, quant, dtype, *_poisoned_paged(
        gen, quant, b, h, kvh, d, bs, seq_lens, mb))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_lens", [
    [2048],                                    # the old design's worst case
    [17, 17, 17, 2048, 17, 17, 17, 17],        # one long among short ones
], ids=["b1", "one-long"])
def test_paged_split_long_sequences(cuda, quant, dtype, seq_lens):
    gen = np.random.default_rng(len(seq_lens) + 20 * quant)
    _split_launch(cuda, quant, dtype, *_poisoned_paged(
        gen, quant, len(seq_lens), 32, 8, 128, 16, seq_lens, 2048 // 16))


def test_paged_split_int8_shared_and_cow_pages(cuda):
    """Rows sharing a 1000-token prefix across many splits, one through a
    COW copy (``kvcache.copy_page``) of its 11th page: the same bits as
    the original, and the plain version's values."""
    from move2kube_tpu_torch.serving import kvcache as tkv

    gen = np.random.default_rng(21)
    mb, bs, kvh = 128, 16, 8
    cfg = tkv.KVCacheConfig(num_layers=1, num_kv_heads=kvh, head_dim=128,
                            block_size=bs, num_pages=70, max_batch=3,
                            max_pages_per_seq=mb, dtype=torch.int8)
    cache = tkv.init_cache(cfg, cuda)
    for key in ("k", "v"):
        q8, sc = tatt.quantize_kv_rows(_randn(gen, 69, bs, kvh, 128).to(cuda))
        cache[key][0][1:] = q8
        cache[key + "_scale"][0][1:] = sc
    tkv.copy_page(cache, 11, 69)
    pools = [cache[key][0] for key in tkv.PAGE_KEYS]
    q = _randn(gen, 1, 32, 128).expand(3, 32, 128).contiguous().to(cuda)
    bt = torch.zeros(3, mb, dtype=torch.int32)
    bt[:, :63] = torch.arange(1, 64)
    bt[1, 10] = 69
    bt = bt.to(cuda)
    sl = torch.tensor([1000, 1000, 500], dtype=torch.int32, device=cuda)
    assert 1000 > 2 * _split_tokens(3, kvh, mb, bs)
    ref = _int8_ref(q, *pools, bt, sl)
    _poison_null_page(*pools)
    out = _int8_launch(q, *pools, bt, sl)
    _assert_int8_close(out, ref, torch.float32)
    assert torch.equal(out[0], out[1])


def test_paged_decode_raises_on_misaligned_pools(cuda):
    """The split pass copies 16 bytes of a row at a time: an fp pool that
    starts off a 16-byte boundary raises, and nothing is launched."""
    buf = torch.zeros(1 + 3 * 8 * 2 * 64, device=cuda)
    pages = buf[1:].view(3, 8, 2, 64)
    assert pages.is_contiguous()
    before = tatt.PAGED_DECODE.launches
    with pytest.raises(ValueError, match="aligned"):
        tatt.paged_decode_attention(
            torch.zeros(1, 4, 64, device=cuda), pages, pages,
            torch.zeros(1, 2, dtype=torch.int32, device=cuda),
            torch.ones(1, dtype=torch.int32, device=cuda))
    assert tatt.PAGED_DECODE.launches == before


def test_paged_decode_int8_kernel_raises_on_what_it_does_not_take(cuda):
    gen = np.random.default_rng(13)

    def args(b=2, h=8, kvh=2, d=64, bs=8, seq_lens=(5, 9)):
        return [t.to(cuda) for t in _paged_int8(gen, b, h, kvh, d, bs,
                                                list(seq_lens))]

    def call(q, k8, v8, ks, vs, bt, sl):
        return tatt.paged_decode_attention(q, k8, v8, bt, sl, k_scale=ks,
                                           v_scale=vs)

    with pytest.raises(ValueError, match="head_dim"):
        call(*args(d=32))
    with pytest.raises(ValueError, match="block_size"):
        call(*args(bs=12))
    with pytest.raises(ValueError, match="query heads"):
        call(*args(h=6))
    a = args()
    with pytest.raises(TypeError, match="fp32 or bf16"):
        call(a[0].half(), *a[1:])
    with pytest.raises(TypeError, match="scale pools must be fp32"):
        call(*a[:3], a[3].half(), a[4].half(), *a[5:])
    with pytest.raises(TypeError, match="int8"):
        call(a[0], a[1].float(), a[2].float(), *a[3:])
    with pytest.raises(TypeError, match="int32"):
        call(*a[:5], a[5].long(), a[6])
    with pytest.raises(ValueError, match="CUDA device"):
        call(*a[:5], a[5].cpu(), a[6])
    with pytest.raises(ValueError, match="contiguous"):
        call(*a[:3], a[3].transpose(0, 1).contiguous().transpose(0, 1),
             *a[4:])
    with pytest.raises(TypeError, match="one dtype"):
        tatt.paged_decode_attention(a[0], a[1], a[2], a[5], a[6])


def test_engine_on_card_matches_engine_on_cpu(cuda):
    """A small model (head_dim 64) in fp32: the engine on the card, through
    both kernels, streams the same greedy tokens as on the CPU."""
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_tiny,
    )

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash")
    cpu_model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
    card_model = init_llama(cfg, seed=0, device="cpu",
                            dtype=torch.float32).to(cuda)
    econf = EngineConfig(max_batch=2, max_seq=64, block_size=8,
                         buckets=(16, 32))
    gen = np.random.default_rng(0)
    prompts = [gen.integers(1, 500, size=n).tolist() for n in (5, 20, 9)]

    def run(model, device):
        eng = ServingEngine(model.eval(), econf, device=device)
        return {c.rid: c.tokens for c in eng.run(
            [Request(f"r{i}", p, 6) for i, p in enumerate(prompts)])}

    tatt.reset_launch_counts()
    on_card = run(card_model, cuda)
    assert tatt.FLASH_FWD.launches == cfg.num_layers * 3
    assert tatt.PAGED_DECODE.launches > 0
    assert on_card == run(cpu_model, "cpu")


def test_int8_kv_engine_on_card_matches_engine_on_cpu(cuda):
    """The int8-kv engine on the card (int8 weights, the int8 cache, the
    flash and int8 paged-decode kernels) streams the same greedy tokens as
    on the CPU, from the same fp32 weights; no fp paged decode runs."""
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_tiny,
    )

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash")
    econf = EngineConfig(max_batch=2, max_seq=64, block_size=8,
                         buckets=(16, 32), quant="int8-kv")
    gen = np.random.default_rng(1)
    prompts = [gen.integers(1, 500, size=n).tolist() for n in (5, 20, 9)]

    def run(device):
        model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
        eng = ServingEngine(model.to(device).eval(), econf, device=device)
        return {c.rid: c.tokens for c in eng.run(
            [Request(f"r{i}", p, 6) for i, p in enumerate(prompts)])}

    tatt.reset_launch_counts()
    on_card = run(cuda)
    assert tatt.FLASH_FWD.launches == cfg.num_layers * 3
    assert tatt.PAGED_DECODE_INT8.launches > 0
    assert tatt.PAGED_DECODE.launches == 0
    assert on_card == run("cpu")


# logits of the engine on the card (the kernels) against the same engine
# on the CPU (their plain versions), fp32, from the same weights: sums in
# other orders through 2 layers
FLEET_LOGITS_ATOL = 1e-4


def _fleet_run(model, device, econf, reqs):
    """One engine run from the CPU model's weights on ``device``; returns
    the streams, logit rows, stats and (on the card) the launch counts of
    the run alone."""
    from move2kube_tpu_torch import ServingEngine

    eng = ServingEngine(model.to(device).eval(), econf, device=device)
    eng.capture_logits = True
    tatt.reset_launch_counts()
    streams = {c.rid: c.tokens for c in eng.run(
        [dataclasses.replace(r, prompt=list(r.prompt)) for r in reqs])}
    launches = {k.name: k.launches for k in tatt.KERNELS}
    return streams, eng.logit_log, eng.stats(), launches


def _fleet_check(cuda, econf, reqs, draft_layers=0):
    """The engine on the card against the engine on the CPU: the same
    streams, every logit row within FLEET_LOGITS_ATOL, and on the card
    one flash launch a layer a prefill and one paged launch a layer a
    single-token pass (decode, hit suffix, verify, chunk, draft)."""
    from move2kube_tpu_torch import init_llama, llama_tiny

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash")
    model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
    want, want_log, _, _ = _fleet_run(model, "cpu", econf, reqs)
    got, got_log, stats, launches = _fleet_run(model, cuda, econf, reqs)
    assert got == want
    for rid, rows in got_log.items():
        assert len(rows) == len(want_log[rid])
        for a, b in zip(rows, want_log[rid]):
            np.testing.assert_allclose(a, b, atol=FLEET_LOGITS_ATOL, rtol=0)
    p = stats["passes"]
    assert launches == {
        "flash_fwd": cfg.num_layers * p["prefill"]
        + draft_layers * p["draft_prefill"],
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "paged_decode": cfg.num_layers * (p["decode"] + p["verify"]
                                          + p["chunk"])
        + draft_layers * p["draft_decode"],
        "paged_decode_int8": 0}
    return stats


def _fleet_requests(seed):
    from move2kube_tpu_torch import Request

    gen = np.random.default_rng(seed)
    shared = gen.integers(1, 500, size=20).tolist()
    return [Request("cold", list(shared), 5), Request("rerun", shared, 5),
            Request("fork", shared[:16] + [3, 5, 7], 5),
            Request("other", gen.integers(1, 500, size=9).tolist(), 5)]


def test_verify_pass_on_card_matches_cpu(cuda):
    """The spec verify window (k + 1 single-token passes of the target)
    and the draft's passes launch the paged kernel on the card and agree
    with their plain versions on the CPU."""
    from move2kube_tpu_torch import EngineConfig

    stats = _fleet_check(cuda, EngineConfig(
        max_batch=4, max_seq=64, block_size=8, buckets=(16, 32), spec_k=3,
        spec_draft_factor=2, admit_burst=0), _fleet_requests(40),
        draft_layers=1)
    assert stats["passes"]["verify"] > 0 and stats["passes"]["decode"] == 0


def test_chunk_pass_on_card_matches_cpu(cuda):
    """Chunked prefill's single-token passes of the chunking row launch
    the paged kernel on the card; the final chunk's logits agree with the
    plain version's on the CPU."""
    from move2kube_tpu_torch import EngineConfig, Request

    gen = np.random.default_rng(41)
    reqs = [Request("long", gen.integers(1, 500, size=45).tolist(), 4),
            Request("short", gen.integers(1, 500, size=7).tolist(), 8)]
    stats = _fleet_check(cuda, EngineConfig(
        max_batch=2, max_seq=64, block_size=8, buckets=(16, 64),
        chunk_prefill=16, admit_burst=0), reqs)
    assert stats["passes"]["chunk"] == 45


def test_hit_suffix_on_card_matches_cpu(cuda):
    """A prefix hit's suffix, fed through decode steps over shared and
    COW-copied pages, launches the paged kernel on the card and agrees
    with the plain version on the CPU."""
    from move2kube_tpu_torch import EngineConfig

    stats = _fleet_check(cuda, EngineConfig(
        max_batch=2, max_seq=64, block_size=8, buckets=(16, 32),
        prefix_cache=True), _fleet_requests(42))
    assert stats["prefix_hits"] == 2 and stats["cow_copies"] >= 1


def test_spec_hit_long_suffix_on_card_matches_cpu(cuda):
    """Spec decode beside prefix hits whose suffixes outrun the verify
    window: fully forced windows of the verify and draft passes launch the
    paged kernel on the card and agree with the plain versions on the
    CPU."""
    from move2kube_tpu_torch import EngineConfig, Request

    gen = np.random.default_rng(43)
    shared = gen.integers(1, 500, size=16).tolist()
    tail = gen.integers(1, 500, size=10).tolist()
    reqs = [Request("cold", list(shared), 5),
            Request("fork", shared[:8] + tail, 5),
            Request("fork2", shared + tail[:7], 5)]
    stats = _fleet_check(cuda, EngineConfig(
        max_batch=4, max_seq=64, block_size=8, buckets=(16, 32),
        prefix_cache=True, spec_k=2, spec_draft_factor=2, admit_burst=0),
        reqs, draft_layers=1)
    assert stats["prefix_hits"] == 2 and stats["prefix_hit_tokens"] == 24


def _tiny_fp32():
    from move2kube_tpu_torch import init_llama, llama_tiny

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash")
    return init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)


def _scripted(device, script):
    """Run ``script(model, device)`` on a fresh copy of the fp32 model on
    ``device`` with the launch counts at 0; returns its result and the
    launch counts of the run alone."""
    model = _tiny_fp32().to(device).eval()
    tatt.reset_launch_counts()
    out = script(model, device)
    return out, {k.name: k.launches for k in tatt.KERNELS}


def _same_on_card(cuda, script):
    """``script`` on the CPU and on the card: the same streams, every
    logit row within FLEET_LOGITS_ATOL. Returns the card's result and
    launch counts."""
    (want, want_log, _), _ = _scripted("cpu", script)
    (got, got_log, passes), launches = _scripted(cuda, script)
    assert got == want
    for rid, rows in got_log.items():
        assert len(rows) == len(want_log[rid])
        for a, b in zip(rows, want_log[rid]):
            np.testing.assert_allclose(a, b, atol=FLEET_LOGITS_ATOL, rtol=0)
    return passes, launches


def _want_launches(layers, prefill, paged):
    return {"flash_fwd": layers * prefill, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "paged_decode": layers * paged,
            "paged_decode_int8": 0}


def test_lora_decode_pass_on_card_matches_cpu(cuda):
    """A batch mixing the base model and two adapters: every prefill and
    decode row carries its slot's delta, the streams and logits agree with
    the CPU's, and the launches are one a layer a pass."""
    from move2kube_tpu_torch import EngineConfig, Request, ServingEngine

    def script(model, device):
        eng = ServingEngine(model, EngineConfig(
            max_batch=4, max_seq=64, block_size=8, buckets=(16, 32),
            max_loras=2, lora_rank=4, admit_burst=0), device=device)
        gen = np.random.default_rng(44)
        for name, r in (("fin", 4), ("law", 2)):
            eng.register_adapter(
                name, (gen.normal(size=(256, r)) * 0.05).astype(np.float32),
                (gen.normal(size=(r, 512)) * 0.05).astype(np.float32))
        eng.capture_logits = True
        reqs = [Request(f"r{i}", gen.integers(1, 500, size=n).tolist(), 6,
                        adapter=a)
                for i, (n, a) in enumerate(((9, "fin"), (14, ""),
                                            (5, "law"), (20, "fin")))]
        out = {c.rid: c.tokens for c in eng.run(reqs)}
        return out, eng.logit_log, eng.stats()["passes"]

    passes, launches = _same_on_card(cuda, script)
    assert launches == _want_launches(2, passes["prefill"],
                                      passes["decode"])


def test_install_prefilled_then_decode_on_card_matches_cpu(cuda):
    """A prefill replica's handoff, through the wire bytes, seated by
    install_prefilled and decoded: the same streams as on the CPU, the
    flash kernel only on the prefill replica and the paged kernel for
    every decode step."""
    from move2kube_tpu_torch import EngineConfig, Request, ServingEngine
    from move2kube_tpu_torch.serving.fleet.disagg import (
        DisaggPair,
        PrefillReplica,
    )

    def script(model, device):
        econf = EngineConfig(max_batch=2, max_seq=64, block_size=8,
                             buckets=(16, 32))
        pre = PrefillReplica(model, econf, device=device)
        eng = ServingEngine(model, econf, device=device)
        eng.capture_logits = True
        gen = np.random.default_rng(45)
        reqs = [Request(f"d{i}", gen.integers(1, 500, size=n).tolist(), 6)
                for i, n in enumerate((11, 25, 7))]
        out = {c.rid: c.tokens for c in DisaggPair(pre, eng).run(reqs)}
        passes = dict(eng.stats()["passes"])
        passes["prefill"] += pre.stats()["passes"]["prefill"]
        return out, eng.logit_log, passes

    passes, launches = _same_on_card(cuda, script)
    assert passes["prefill"] == 3
    assert launches == _want_launches(2, 3, passes["decode"])


def test_other_weights_swap_mid_decode_on_card_matches_cpu(cuda):
    """install_weights of other weights (every tensor x 1.25) after 3
    tokens, on the card and on the CPU: the same stream, logits before
    and after the swap within FLEET_LOGITS_ATOL."""
    from move2kube_tpu_torch import EngineConfig, Request, ServingEngine

    def script(model, device):
        eng = ServingEngine(model, EngineConfig(
            max_batch=2, max_seq=64, block_size=8, buckets=(16, 32)),
            device=device)
        eng.capture_logits = True
        new = {k: v * 1.25 for k, v in model.state_dict().items()}
        gen = np.random.default_rng(46)
        eng.submit(Request("s", gen.integers(1, 500, size=12).tolist(), 8))
        done, swapped = [], False
        while eng.has_work():
            done += eng.step()
            slot = eng._slots[0]
            if not swapped and slot is not None and len(slot.tokens) >= 3:
                assert eng.install_weights(new, version=4) == 4
                swapped = True
        assert swapped and done[0].weights_version == 4
        return ({c.rid: c.tokens for c in done}, eng.logit_log,
                eng.stats()["passes"])

    passes, launches = _same_on_card(cuda, script)
    assert launches == _want_launches(2, passes["prefill"],
                                      passes["decode"])


# ----------------------------------------------------------------------
# the model families: GPT-2 at its own head_dim (64, MHA) and the MoE
# Llama on the kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt2_shape_flash_forward_and_backward(cuda, dtype):
    """The flash forward and both backward kernels at GPT-2 small's
    attention (h = kvh = 12, d = 64, s = 1024, causal) against the plain
    versions, by the flash rule and the backward rule in bf16."""
    s, h, d = 1024, 12, 64
    q, k, v, o, lse, g = _bwd_inputs(cuda, dtype, 64, s, s, h, h, d, True)
    out, lse_k = tatt.flash_attention_fwd(q, k, v, True, d ** -0.5)
    ref = tatt.reference_attention(q.float(), k.float(), v.float(), True,
                                   d ** -0.5)
    torch.cuda.synchronize()
    _assert_flash_close(out, q, k, v, True, ref)
    torch.testing.assert_close(lse_k, lse, atol=LSE_ATOL, rtol=0)
    got = tatt.flash_attention_bwd(q, k, v, o, lse, g, True, d ** -0.5)
    want = tatt.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, g.float(), True,
        d ** -0.5)
    terms = tatt.flash_attention_bwd_abs_terms(q, k, v, o, lse, g, True,
                                               d ** -0.5)
    torch.cuda.synchronize()
    _assert_bwd_close(got, want, terms, dtype)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpt2_shape_paged_decode(cuda, quant, dtype):
    """Paged decode at the GPT-2 slice's decode batch: b = 8 slots, h =
    kvh = 12, d = 64, pages of 16, lengths up to n_positions (1024); the
    fp pools and the int8 ones with their row scales."""
    h, d, bs = 12, 64, 16
    seq_lens = [1024, 17, 640, 1, 333, 900, 64, 129]
    gen = np.random.default_rng(12)
    q, kp, vp, bt, sl = _paged(gen, 8, h, h, d, bs, seq_lens)
    q = q.to(cuda, dtype)
    bt, sl = bt.to(cuda), sl.to(cuda)
    if quant:
        k8, ks = tatt.quantize_kv_rows(kp)
        v8, vs = tatt.quantize_kv_rows(vp)
        k8, ks, v8, vs = (t.to(cuda) for t in (k8, ks, v8, vs))
        out = tatt.paged_decode_attention(q, k8, v8, bt, sl, k_scale=ks,
                                          v_scale=vs)
        ref = tatt.paged_decode_int8_reference(q.float(), k8, v8, ks, vs, bt,
                                               sl, d ** -0.5)
    else:
        kp, vp = kp.to(cuda, dtype), vp.to(cuda, dtype)
        out = tatt.paged_decode_attention(q, kp, vp, bt, sl)
        ref = tatt.paged_decode_reference(q.float(), kp.float(), vp.float(),
                                          bt, sl, d ** -0.5)
    torch.cuda.synchronize()
    _assert_kernel_close(out, ref, dtype)


def _small_gpt2():
    from move2kube_tpu_torch import GPT2Config

    # gpt2_tiny's head_dim (16) is below the kernels' 64: 2 heads of 64
    return GPT2Config(vocab_size=256, n_positions=128, d_model=128,
                      num_layers=2, num_heads=2, dtype=torch.float32)


@pytest.mark.parametrize("quant", ["off", "int8-kv"])
def test_gpt2_engine_on_card_matches_engine_on_cpu(cuda, quant):
    """A small GPT-2 (head_dim 64) in fp32: the engine on the card, through
    the flash and paged kernels (the int8 one under int8-kv), streams the
    same greedy tokens as on the CPU; launches exactly one flash a layer a
    prefill and one paged decode a layer a decode step."""
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_gpt2,
    )

    cfg = _small_gpt2()
    econf = EngineConfig(max_batch=2, max_seq=64, block_size=8,
                         buckets=(16, 32), quant=quant)
    gen = np.random.default_rng(2)
    prompts = [gen.integers(1, 256, size=n).tolist() for n in (5, 20, 9)]

    def run(device):
        model = init_gpt2(cfg, seed=0, device="cpu").to(device).eval()
        eng = ServingEngine(model, econf, device=device)
        out = {c.rid: c.tokens for c in eng.run(
            [Request(f"r{i}", p, 6) for i, p in enumerate(prompts)])}
        return out, eng.stats()

    tatt.reset_launch_counts()
    on_card, stats = run(cuda)
    paged = tatt.PAGED_DECODE_INT8 if quant == "int8-kv" else (
        tatt.PAGED_DECODE)
    assert tatt.FLASH_FWD.launches == cfg.num_layers * stats["prefills"]
    assert paged.launches == cfg.num_layers * stats["decode_steps"]
    assert on_card == run("cpu")[0]


def test_gpt2_train_step_on_card_matches_cpu(cuda):
    """Two fp32 steps of the small GPT-2 with remat, the tied head folded
    into the chunked loss, on the card through all three flash kernels,
    against the same steps on the CPU."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_gpt2,
        make_lm_train_step,
        policy,
    )

    cfg = _small_gpt2()
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 2, 96)))
    step = make_lm_train_step(remat=True, precision=policy("fp32"),
                              chunk=128)

    def run(device):
        model = init_gpt2(cfg, seed=0, device="cpu").to(device)
        state = TrainState(model, adamw(model.parameters(), 1e-3, 0.1))
        return [float(step(state, {"input_ids": b})[1]) for b in ids]

    tatt.reset_launch_counts()
    on_card = run(cuda)
    n = cfg.num_layers * len(ids)
    assert [k.launches for k in tatt.KERNELS] == [2 * n, n, n, 0, 0]
    np.testing.assert_allclose(on_card, run("cpu"), rtol=1e-5)


def test_moe_engine_on_card_matches_engine_on_cpu(cuda):
    """A small MoE Llama (head_dim 64, 4 experts, top-2) in fp32: the
    engine on the card streams the same greedy tokens as on the CPU, idle
    rows and all (they take part in the routing)."""
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_tiny,
    )

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash",
                              moe_experts=4)
    econf = EngineConfig(max_batch=4, max_seq=64, block_size=8,
                         buckets=(16, 32))
    gen = np.random.default_rng(4)
    prompts = [gen.integers(1, 500, size=n).tolist() for n in (5, 20, 9)]

    def run(device):
        model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
        eng = ServingEngine(model.to(device).eval(), econf, device=device)
        return {c.rid: c.tokens for c in eng.run(
            [Request(f"r{i}", p, 6) for i, p in enumerate(prompts)])}

    tatt.reset_launch_counts()
    on_card = run(cuda)
    assert tatt.FLASH_FWD.launches == cfg.num_layers * 3
    assert tatt.PAGED_DECODE.launches > 0
    assert on_card == run("cpu")
