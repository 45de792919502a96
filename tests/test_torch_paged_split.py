"""The paged-decode kernels' split over the sequence and its merge, on the
CPU.

``csrc/paged_decode.cu`` and ``csrc/paged_decode_int8.cu`` cut each
sequence's pages into splits (``paged_split_plan``), compute a partial
online-softmax state ``(m, l, acc)`` per live split and merge the partials
in split order. The kernels run only on a card
(tests/test_torch_kernels_cuda.py); here the planner is checked as it
stands, and a plain emulation of split-then-merge, written in this file and
on no path of the package, is held against the JAX package's
``_paged_decode_reference`` on fp32, bf16 and int8 pools. That pins the
algebra the CUDA code implements: which tokens a split takes, the scale
fold carried across splits, and the merge
``out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.ops import attention as jatt  # noqa: E402
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

# emulation and reference both in fp32, sums taken in another order
ATOL = 1e-5
H100_SMS = 132


# ----------------------------------------------------------------------
# the planner
# ----------------------------------------------------------------------


@pytest.mark.parametrize("sm_count", [8, H100_SMS])
@pytest.mark.parametrize("block_size", [8, 16])
@pytest.mark.parametrize("max_blocks", [1, 7, 128, 256])
@pytest.mark.parametrize("kvh", [1, 8])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_split_plan_covers_every_page_once(b, kvh, max_blocks, block_size,
                                           sm_count):
    pps, n_split = tatt.paged_split_plan(b, kvh, max_blocks, block_size,
                                         sm_count)
    assert type(pps) is int and type(n_split) is int
    assert 1 <= pps <= max_blocks and n_split >= 1
    # whole pages, so a multiple of the kernels' 8-token groups
    assert (pps * block_size) % 8 == 0
    owner = np.full(max_blocks, -1)
    for s in range(n_split):
        pages = np.arange(s * pps, min((s + 1) * pps, max_blocks))
        assert pages.size, f"split {s} holds no page of the table"
        assert (owner[pages] == -1).all()
        owner[pages] = s
    assert (owner >= 0).all()
    assert (n_split == 1) == (pps >= max_blocks)
    # halved from PAGED_SPLIT_TOKENS only while the grid was short of its
    # target, never below the floor; short of it only at the floor
    target = tatt._SPLIT_BLOCKS_PER_SM * sm_count
    start = max(1, tatt.PAGED_SPLIT_TOKENS // block_size)
    if pps < min(start, max_blocks):
        assert pps * block_size >= tatt._SPLIT_MIN_TOKENS
        assert b * kvh * -(-max_blocks // (2 * pps)) < target
    if b * kvh * n_split < target:
        assert pps == 1 or (pps // 2) * block_size < tatt._SPLIT_MIN_TOKENS


def test_split_plan_reaches_its_block_target_at_the_slice_shape():
    """chip_smoke.py's paged batch: b=8, kvh=8, 2048 tokens in pages of 16
    on an H100's 132 SMs."""
    pps, n_split = tatt.paged_split_plan(8, 8, 2048 // 16, 16, H100_SMS)
    assert 8 * 8 * n_split >= tatt._SPLIT_BLOCKS_PER_SM * H100_SMS
    assert pps * 16 == tatt.PAGED_SPLIT_TOKENS
    # the old design's worst case, one sequence: smaller splits fill the card
    pps1, n1 = tatt.paged_split_plan(1, 8, 2048 // 16, 16, H100_SMS)
    assert pps1 < pps and 8 * n1 > 8 * 2048 // tatt.PAGED_SPLIT_TOKENS


def test_split_plan_is_a_pure_function_of_host_integers(monkeypatch):
    """The same integers give the same plan, with no device to ask: the
    wrapper adds no device-to-host read to a decode step."""
    def no_device(*a, **k):
        raise AssertionError("the planner asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    args = (8, 8, 128, 16, H100_SMS)
    assert tatt.paged_split_plan(*args) == tatt.paged_split_plan(*args)
    assert tatt.paged_split_plan(*args, split_tokens=64) == (4, 32)
    assert tatt.paged_split_plan(*args, split_tokens=256) == (16, 8)


# ----------------------------------------------------------------------
# split-then-merge, emulated
# ----------------------------------------------------------------------


def _split_merge(q, k_pages, v_pages, block_tables, seq_lens, scale, pps,
                 k_scale=None, v_scale=None, drop_last=False):
    """What the kernels compute, in plain fp32: for each (sequence, KV head)
    and each live split of ``pps`` pages, the partial ``(m, l, acc)`` of
    its tokens (int8: scores times k_scale after the product, acc summing
    (p v_scale) v8, l summing p); then the merge in split order. A split
    starting at or past the sequence's length contributes nothing.
    ``drop_last`` leaves out the last live split of each sequence that has
    more than one: the planted fault."""
    b, h, d = q.shape
    _, bs, kvh, _ = k_pages.shape
    mb = block_tables.shape[1]
    rep = h // kvh
    split_tok = pps * bs
    out = torch.zeros(b, h, d)
    for bi in range(b):
        n_tok = min(max(int(seq_lens[bi]), 0), mb * bs)
        n_live = max(1, -(-n_tok // split_tok))
        if drop_last and n_live > 1:
            n_live -= 1
        for g in range(kvh):
            qg = q[bi, g * rep:(g + 1) * rep].float() * scale  # [rep, d]
            parts = []
            for s in range(n_live):
                t = torch.arange(s * split_tok, min((s + 1) * split_tok,
                                                    n_tok))
                pages = block_tables[bi, t // bs].long()
                k = k_pages[pages, t % bs, g].float()  # [n, d]
                v = v_pages[pages, t % bs, g].float()
                sc = qg @ k.T  # [rep, n]
                if k_scale is not None:
                    sc = sc * k_scale[pages, t % bs, g][None, :]
                    v = v * v_scale[pages, t % bs, g][:, None]
                m = sc.max(dim=1).values if t.numel() else torch.full(
                    (rep,), -1e30)
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(dim=1), p @ v))
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            num = torch.zeros(rep, d)
            den = torch.zeros(rep)
            for m, l_, acc in parts:
                c = torch.exp(m - mx)
                den = den + l_ * c
                num = num + acc * c[:, None]
            out[bi, g * rep:(g + 1) * rep] = num / torch.clamp_min(
                den[:, None], 1e-30)
    return out


def _inputs(rng, pool, rep, d, bs=8, kvh=2, sm_count=32):
    """A batch whose lengths sit at and around the split boundaries, with 1
    and the table's full length; pools of ``pool`` (fp32, bf16-valued fp32,
    or int8 from ``quantize_kv_rows``), disjoint page runs; the plan at
    this batch's grid."""
    mb = 24
    b = 8
    pps, n_split = tatt.paged_split_plan(b, kvh, mb, bs, sm_count)
    assert n_split >= 3
    sp = pps * bs
    seq_lens = np.array([sp - 1, sp, sp + 1, 1, mb * bs, 2 * sp, 2 * sp + 1,
                         sp // 2], np.int32)
    need = [-(-int(n) // bs) for n in seq_lens]
    num_pages = 1 + sum(need) + 2
    order = rng.permutation(np.arange(1, num_pages)).tolist()
    bt = np.zeros((b, mb), np.int32)
    for i, n in enumerate(need):
        bt[i, :n] = [order.pop() for _ in range(n)]
    q = rng.standard_normal((b, kvh * rep, d)).astype(np.float32)
    k = rng.standard_normal((num_pages, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, bs, kvh, d)).astype(np.float32)
    if pool == "bf16":
        # the kernel computes in fp32 on bf16 values
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v))
    pools = {"k": k, "v": v}
    if pool == "int8":
        pools["k"], pools["k_scale"] = (
            np.array(x) for x in jatt.quantize_kv_rows(jnp.asarray(k)))
        pools["v"], pools["v_scale"] = (
            np.array(x) for x in jatt.quantize_kv_rows(jnp.asarray(v)))
    return q, pools, bt, seq_lens, pps


def _jax_ref(q, pools, bt, seq_lens, scale):
    kw = {}
    if "k_scale" in pools:
        kw = {"k_scale": jnp.asarray(pools["k_scale"]),
              "v_scale": jnp.asarray(pools["v_scale"])}
    return np.asarray(jatt._paged_decode_reference(
        jnp.asarray(q), jnp.asarray(pools["k"]), jnp.asarray(pools["v"]),
        jnp.asarray(bt), jnp.asarray(seq_lens), scale, **kw))


def _emulate(q, pools, bt, seq_lens, scale, pps, drop_last=False):
    t = {key: torch.from_numpy(x) for key, x in pools.items()}
    return _split_merge(torch.from_numpy(q), t["k"], t["v"],
                        torch.from_numpy(bt), torch.from_numpy(seq_lens),
                        scale, pps, t.get("k_scale"), t.get("v_scale"),
                        drop_last=drop_last).numpy()


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_split_then_merge_matches_jax_reference(pool, rep, d):
    rng = np.random.default_rng(d + 10 * rep + len(pool))
    q, pools, bt, seq_lens, pps = _inputs(rng, pool, rep, d)
    scale = d ** -0.5
    ours = _emulate(q, pools, bt, seq_lens, scale, pps)
    ref = _jax_ref(q, pools, bt, seq_lens, scale)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_merge_that_drops_the_last_live_split_fails(pool):
    """The planted fault the card's paged phases must catch: leaving out
    each sequence's last live split moves every multi-split sequence's
    output far past the tolerance, and leaves the one-split ones as they
    are."""
    rng = np.random.default_rng(3)
    q, pools, bt, seq_lens, pps = _inputs(rng, pool, 4, 128)
    scale = 128 ** -0.5
    bad = _emulate(q, pools, bt, seq_lens, scale, pps, drop_last=True)
    ref = _jax_ref(q, pools, bt, seq_lens, scale)
    err = np.abs(bad - ref).max(axis=(1, 2))
    multi = seq_lens > pps * pools["k"].shape[1]
    assert multi.any() and (~multi).any()
    assert (err[multi] > 100 * ATOL).all()
    assert (err[~multi] <= ATOL).all()


def test_split_then_merge_at_the_slice_layout():
    """The slice's heads (32 over 8 KV heads, d 128, pages of 16) on the
    plan an H100 gets, int8 pools: 32-token splits, 12 of them."""
    rng = np.random.default_rng(5)
    q, pools, bt, seq_lens, pps = _inputs(rng, "int8", 4, 128, bs=16,
                                          kvh=8, sm_count=H100_SMS)
    scale = 128 ** -0.5
    np.testing.assert_allclose(
        _emulate(q, pools, bt, seq_lens, scale, pps),
        _jax_ref(q, pools, bt, seq_lens, scale), atol=ATOL, rtol=0)
