"""The port's int8 KV cache and int8 paged decode against the JAX
package's.

Inputs are drawn with numpy from a seed and handed to both sides. On the
CPU the port's ``paged_decode_attention`` takes its plain int8 version;
the JAX side runs its jnp reference (``_paged_decode_reference`` with
row scales) and its Pallas kernel ``_paged_decode_packed`` through the
interpreter. The CUDA kernel itself is held against the plain version by
tests/test_torch_kernels_cuda.py (on a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.ops import attention as jatt  # noqa: E402
from move2kube_tpu.serving import kvcache as jkv  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402
from move2kube_tpu_torch.serving import kvcache as tkv  # noqa: E402

# int8 paged decode, fp32 accumulation on both sides in another order: the
# bound tests/test_kernels.py holds the Pallas kernel to (its ATOL)
ATOL = 2e-5
# tests/test_kernels.py's shapes
B, H, KVH, D, BS, MB = 3, 4, 2, 32, 8, 8


def _int8_pools(rng, num_pages, bs=BS, kvh=KVH, d=D):
    kp = rng.integers(-127, 128, size=(num_pages, bs, kvh, d)).astype(np.int8)
    vp = rng.integers(-127, 128, size=(num_pages, bs, kvh, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, size=(num_pages, bs, kvh)).astype(
        np.float32)
    vs = rng.uniform(0.001, 0.02, size=(num_pages, bs, kvh)).astype(
        np.float32)
    return kp, vp, ks, vs


def _tables(lens, mb=MB, bs=BS):
    """Disjoint page runs per sequence, pages 1.. (0 is the null page)."""
    bt = np.zeros((len(lens), mb), np.int32)
    used = 1
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        bt[i, :pages] = np.arange(used, used + pages)
        used += pages
    return bt, np.asarray(lens, np.int32)


def _ours(q, kp, vp, ks, vs, bt, sl):
    return tatt.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, bt, sl)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()


def _check_against_jax(q, kp, vp, ks, vs, bt, sl, ppts=(1, 2, 4)):
    """The plain int8 version against the JAX reference and the Pallas
    kernel in interpret mode at each pages-per-tile; returns ours."""
    ours = _ours(q, kp, vp, ks, vs, bt, sl)
    assert ours.dtype == np.float32 and ours.shape == q.shape
    j = [jnp.asarray(x) for x in (q, kp, vp, bt, sl)]
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    scale = q.shape[-1] ** -0.5
    ref = np.asarray(jatt._paged_decode_reference(*j, scale, **kw))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    for ppt in ppts:
        kern = np.asarray(jatt._paged_decode_packed(
            *j, scale, pages_per_tile=ppt, interpret=True, **kw))
        np.testing.assert_allclose(ours, kern, atol=ATOL, rtol=0,
                                   err_msg=f"pages_per_tile={ppt}")
    return ours


# ----------------------------------------------------------------------
# row quantizer
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_equal_jax(dtype):
    """Bit-equal int8 rows and scales, including an all-zero row (scale
    1e-8 / 127) and rows that reach +-127."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7, KVH, D)) * 3).astype(np.float32)
    x[1, 2, 0] = 0.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q8, sc = tatt.quantize_kv_rows(tx)
    jq8, jsc = jatt.quantize_kv_rows(jnp.asarray(x, getattr(jnp, dtype)))
    assert q8.dtype == torch.int8 and sc.dtype == torch.float32
    assert q8.shape == x.shape and sc.shape == x.shape[:3]
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert np.abs(q8.numpy()).max() == 127


# ----------------------------------------------------------------------
# plain int8 paged decode vs both JAX paths
# ----------------------------------------------------------------------


@pytest.mark.parametrize("lens", [[5, 37, 64], [1, 8, 9], [63, 16, 2]])
def test_plain_int8_decode_ragged_tails(lens):
    """Partial last pages, a page boundary plus one, full rows, length 1."""
    rng = np.random.default_rng(sum(lens))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp, vp, ks, vs = _int8_pools(rng, 30)
    bt, sl = _tables(lens)
    _check_against_jax(q, kp, vp, ks, vs, bt, sl)


def test_plain_int8_decode_null_page_poisoned():
    """The null page's scales poisoned with 50.0 (and, through table
    padding, gathered by every row): masked positions must not leak."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    kp, vp, ks, vs = _int8_pools(rng, 12)
    ks[0] = 50.0
    vs[0] = 50.0
    bt, sl = _tables([3, 33], mb=5)
    ours = _check_against_jax(q, kp, vp, ks, vs, bt, sl)
    # the same result with a harmless null page
    ks[0] = vs[0] = 0.01
    np.testing.assert_allclose(ours, _ours(q, kp, vp, ks, vs, bt, sl),
                               atol=ATOL, rtol=0)


def test_plain_int8_decode_shared_prefix_pages():
    """Two rows whose tables share prefix pages read them identically."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, H, D)).astype(np.float32)
    kp, vp, ks, vs = _int8_pools(rng, 16)
    bt = np.array([[1, 2, 3, 4, 0, 0], [1, 2, 3, 5, 6, 0]], np.int32)
    sl = np.array([28, 44], np.int32)
    _check_against_jax(q, kp, vp, ks, vs, bt, sl)


def test_plain_int8_decode_bf16_query():
    """A bf16 query gives a bf16 result: the JAX reference's on the same
    bf16 query, within one bf16 ulp (2**-7 of the value) where the two
    fp32 sums, taken in other orders, straddle a rounding boundary."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp, vp, ks, vs = _int8_pools(rng, 30)
    bt, sl = _tables([5, 37, 64])
    tq = torch.from_numpy(q).bfloat16()
    ours = tatt.paged_decode_attention(
        tq, *(torch.from_numpy(x) for x in (kp, vp, bt, sl)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert ours.dtype == torch.bfloat16
    ref = jatt._paged_decode_reference(
        jnp.asarray(tq.float().numpy(), jnp.bfloat16),
        *(jnp.asarray(x) for x in (kp, vp, bt, sl)), D ** -0.5,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL,
                               rtol=2.0 ** -7)


# ----------------------------------------------------------------------
# int8 cache layout and page operations
# ----------------------------------------------------------------------


def _specs(num_pages=8, max_batch=2, mpps=4):
    ours = tkv.KVCacheConfig(num_layers=2, num_kv_heads=KVH, head_dim=D,
                             block_size=BS, num_pages=num_pages,
                             max_batch=max_batch, max_pages_per_seq=mpps,
                             dtype=torch.int8)
    theirs = jkv.KVCacheConfig(num_layers=2, num_kv_heads=KVH, head_dim=D,
                               block_size=BS, num_pages=num_pages,
                               max_batch=max_batch, max_pages_per_seq=mpps,
                               dtype=jnp.int8)
    return ours, theirs


def test_int8_cache_layout_equals_jax():
    ours, theirs = _specs()
    assert ours.quantized and theirs.quantized
    assert tkv.PAGE_KEYS == jkv.PAGE_KEYS
    tc, jc = tkv.init_cache(ours, "cpu"), jkv.init_cache(theirs)
    assert list(tc) == list(jc)
    for key in jkv.PAGE_KEYS:
        assert len(tc[key]) == len(jc[key]) == 2
        for t, j in zip(tc[key], jc[key]):
            assert tuple(t.shape) == j.shape, key
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype), key
            assert not t.any()
    for key in ("block_tables", "seq_lens"):
        assert tuple(tc[key].shape) == jc[key].shape
    fp = tkv.init_cache(tkv.KVCacheConfig(num_layers=1, num_kv_heads=KVH,
                                          head_dim=D), "cpu")
    assert "k_scale" not in fp and not tkv.KVCacheConfig(
        num_layers=1, num_kv_heads=KVH, head_dim=D).quantized


def test_spec_for_model_cache_dtype_matches_jax():
    ours = tkv.spec_for_model(tllama.llama_tiny(), block_size=8, max_batch=2,
                              max_seq=64, cache_dtype=torch.int8)
    theirs = jkv.spec_for_model(jllama.llama_tiny(), block_size=8,
                                max_batch=2, max_seq=64,
                                cache_dtype=jnp.int8)
    assert ours.quantized and theirs.quantized
    assert ours.dtype == torch.int8 and ours.scale_dtype == torch.float32
    assert ours.num_pages == theirs.num_pages
    assert tkv.spec_for_model(tllama.llama_tiny()).dtype == torch.bfloat16


def test_copy_page_copies_pages_and_scales_as_jax():
    ours, theirs = _specs()
    tc, jc = tkv.init_cache(ours, "cpu"), jkv.init_cache(theirs)
    rng = np.random.default_rng(4)
    for key in jkv.PAGE_KEYS:
        for layer in range(2):
            shape = jc[key][layer].shape
            x = (rng.integers(-127, 128, size=shape).astype(np.int8)
                 if key in ("k", "v")
                 else rng.uniform(0.001, 0.02, size=shape).astype(np.float32))
            tc[key][layer].copy_(torch.from_numpy(x))
            jc[key][layer] = jnp.asarray(x)
    out = tkv.copy_page(tc, 2, 5)
    assert out is tc
    jc = jkv.copy_page(jc, 2, 5)
    for key in jkv.PAGE_KEYS:
        for layer in range(2):
            np.testing.assert_array_equal(tc[key][layer].numpy(),
                                          np.asarray(jc[key][layer]))
            np.testing.assert_array_equal(tc[key][layer][5].numpy(),
                                          tc[key][layer][2].numpy())
    del tc["v_scale"]
    with pytest.raises(ValueError, match="schema"):
        tkv.copy_page(tc, 1, 2)


@pytest.mark.parametrize("plen,bucket", [(11, 16), (5, 32)])
def test_scatter_prefill_int8_equals_jax(plen, bucket):
    """The same prefill K/V lands as the same int8 rows and scales. The
    null page collects bucket padding; where two padded positions share
    one of its rows the write order is unspecified on both sides, so it
    is compared only when no two do."""
    ours, theirs = _specs(num_pages=9, max_batch=2, mpps=4)
    rng = np.random.default_rng(plen)
    kvs = [tuple(rng.standard_normal((1, bucket, KVH, D)).astype(np.float32)
                 for _ in range(2)) for _ in range(2)]
    bt_row = np.array([3, 6, 0, 0], np.int32)  # plen + 4 tokens: 2 pages
    tc = tkv.init_cache(ours, "cpu")
    tkv.scatter_prefill(tc, [(torch.from_numpy(k), torch.from_numpy(v))
                             for k, v in kvs], 1, torch.from_numpy(bt_row),
                        plen, BS)
    jc = jkv.scatter_prefill(jkv.init_cache(theirs),
                             [(jnp.asarray(k), jnp.asarray(v))
                              for k, v in kvs], 1, jnp.asarray(bt_row), plen,
                             BS)
    first_page = 0 if bucket - plen <= BS else 1
    for key in jkv.PAGE_KEYS:
        for layer in range(2):
            np.testing.assert_array_equal(
                tc[key][layer].numpy()[first_page:],
                np.asarray(jc[key][layer])[first_page:], err_msg=key)
    np.testing.assert_array_equal(tc["block_tables"].numpy(),
                                  np.asarray(jc["block_tables"]))
    np.testing.assert_array_equal(tc["seq_lens"].numpy(),
                                  np.asarray(jc["seq_lens"]))


def test_plain_int8_decode_cow_copied_page():
    """A COW copy (copy_page) of a page with its scales reads as the
    original; a later write to the copy moves only the row that holds it.
    Both sides run on the port's cache after the copy."""
    tc = tkv.init_cache(_specs()[0], "cpu")
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((16, KVH, D)).astype(np.float32)
    q8, sc = tatt.quantize_kv_rows(torch.from_numpy(rows))
    for key in ("k", "v"):
        tc[key][0][1:3] = q8.reshape(2, BS, KVH, D)
    for key in ("k_scale", "v_scale"):
        tc[key][0][1:3] = sc.reshape(2, BS, KVH)
    tkv.copy_page(tc, 2, 3)
    q = np.broadcast_to(rng.standard_normal((1, H, D)).astype(np.float32),
                        (2, H, D)).copy()
    bt = np.array([[1, 2, 0, 0], [1, 3, 0, 0]], np.int32)
    sl = np.array([16, 16], np.int32)

    def pools():
        return [tc[key][0].numpy().copy() for key in jkv.PAGE_KEYS]

    kp, vp, ks, vs = pools()
    out = _check_against_jax(q, kp, vp, ks, vs, bt, sl, ppts=(2,))
    np.testing.assert_allclose(out[0], out[1], atol=ATOL, rtol=0)
    tc["k"][0][3] = 7
    kp, vp, ks, vs = pools()
    out2 = _check_against_jax(q, kp, vp, ks, vs, bt, sl, ppts=(2,))
    np.testing.assert_allclose(out2[0], out[0], atol=ATOL, rtol=0)
    assert np.abs(out2[1] - out[1]).max() > 1e-3


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------


def test_int8_wrapper_on_cpu_takes_plain_path_without_launching():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp, vp, ks, vs = _int8_pools(rng, 30)
    bt, sl = _tables([5, 37, 64])
    tatt.reset_launch_counts()
    _ours(q, kp, vp, ks, vs, bt, sl)
    assert all(k.launches == 0 for k in tatt.KERNELS)
    assert tatt.PAGED_DECODE_INT8.source.name == "paged_decode_int8.cu"


def test_int8_wrapper_rejects_bad_scales():
    pages = torch.zeros(3, 8, 2, 32, dtype=torch.int8)
    scales = torch.ones(3, 8, 2)
    args = (torch.zeros(1, 4, 32), pages, pages,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="both"):
        tatt.paged_decode_attention(*args, k_scale=scales)
    with pytest.raises(ValueError, match="scale pools"):
        tatt.paged_decode_attention(*args, k_scale=scales,
                                    v_scale=torch.ones(3, 8, 1))
    with pytest.raises(ValueError, match="no implementation"):
        tatt.paged_decode_attention(
            *(a.to("meta") for a in args), k_scale=scales.to("meta"),
            v_scale=scales.to("meta"))
