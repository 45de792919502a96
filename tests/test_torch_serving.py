"""The port's paged KV cache and engine against the JAX package's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import kvcache as jkv  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import kvcache as tkv  # noqa: E402

# logits, port engine vs JAX engine, fp32 on the CPU: the full-forward
# bound of tests/test_torch_llama.py, as prefill and decode both end there
ENGINE_LOGITS_ATOL = 1e-4


# ----------------------------------------------------------------------
# allocator + geometry
# ----------------------------------------------------------------------


def test_page_allocator_mirrors_jax():
    """tests/test_serving.py::test_page_allocator's cases on both
    allocators, plus LIFO order and refcounts: the same call sequence
    hands out the same pages."""
    allocs = [tkv.PageAllocator(9), jkv.PageAllocator(9)]
    for alloc in allocs:
        assert alloc.available == 8
    a = [x.alloc(3) for x in allocs]
    assert a[0] == a[1] and tkv.NULL_PAGE not in a[0]
    b = [x.alloc(5) for x in allocs]
    assert b[0] == b[1] and not set(a[0]) & set(b[0])
    for alloc in allocs:
        assert alloc.alloc(1) is None      # all-or-nothing: pool empty
    for x, pages in zip(allocs, a):
        x.free(pages)
    for alloc in allocs:
        assert alloc.available == 3
        assert alloc.alloc(4) is None      # never partially
        assert alloc.available == 3
    for x, pages in zip(allocs, a):
        with pytest.raises(ValueError):
            x.free(pages)                  # double free
        with pytest.raises(ValueError):
            x.free([tkv.NULL_PAGE])        # page 0 never circulates
    # LIFO: the last page freed is the first handed out again
    got = [x.alloc(1) for x in allocs]
    assert got[0] == got[1] == [a[0][-1]]
    # refcounts: a shared page survives its first free
    for x, pages in zip(allocs, got):
        x.incref(pages)
        assert x.refcount(pages[0]) == 2
        x.free(pages)
        assert x.refcount(pages[0]) == 1 and x.available == 2
        x.free(pages)
        assert x.refcount(pages[0]) == 0 and x.available == 3
        with pytest.raises(ValueError):
            x.incref(pages)                # no longer allocated
        with pytest.raises(ValueError):
            x.incref([tkv.NULL_PAGE])


@pytest.mark.parametrize("n,bs", [(1, 8), (8, 8), (9, 8), (64, 16)])
def test_pages_for_matches_jax(n, bs):
    assert tkv.pages_for(n, bs) == jkv.pages_for(n, bs)


def test_spec_for_model_matches_jax():
    ours = tkv.spec_for_model(tllama.llama_tiny(), block_size=8,
                              max_batch=4, max_seq=64)
    theirs = jkv.spec_for_model(jllama.llama_tiny(), block_size=8,
                                max_batch=4, max_seq=64)
    for field in ("num_layers", "num_kv_heads", "head_dim", "block_size",
                  "num_pages", "max_batch", "max_pages_per_seq", "max_seq"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.dtype == torch.bfloat16


def test_sanitized_views_match_jax():
    rng = np.random.default_rng(0)
    bt = rng.integers(1, 30, size=(4, 5)).astype(np.int32)
    sl = rng.integers(1, 40, size=(4,)).astype(np.int32)
    active = np.array([True, False, True, False])
    tbt, tpos = tkv.sanitized_views(
        {"block_tables": torch.from_numpy(bt),
         "seq_lens": torch.from_numpy(sl)}, torch.from_numpy(active))
    jbt, jpos = jkv.sanitized_views(
        {"block_tables": jnp.asarray(bt), "seq_lens": jnp.asarray(sl)},
        jnp.asarray(active))
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("plen,bucket", [(11, 16), (5, 32)])
def test_scatter_prefill_pages_equal_jax(plen, bucket):
    """The same prefill K/V lands in byte-identical pages, tables and
    lengths on both sides. The null page collects bucket padding; where
    two padded positions share one of its rows the write order is
    unspecified on both sides, so it is compared only when no two do."""
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32)
    spec = tkv.spec_for_model(cfg, block_size=8, max_batch=2, max_seq=64)
    jspec = jkv.spec_for_model(
        dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32),
        block_size=8, max_batch=2, max_seq=64)
    rng = np.random.default_rng(plen)
    kvs = [(rng.standard_normal((1, bucket, spec.num_kv_heads,
                                 spec.head_dim)).astype(np.float32),
            rng.standard_normal((1, bucket, spec.num_kv_heads,
                                 spec.head_dim)).astype(np.float32))
           for _ in range(spec.num_layers)]
    pages = tkv.PageAllocator(spec.num_pages).alloc(
        tkv.pages_for(plen + 4, 8))
    bt_row = np.full((spec.max_pages_per_seq,), tkv.NULL_PAGE, np.int32)
    bt_row[:len(pages)] = pages
    ours = tkv.init_cache(spec, "cpu")
    tkv.scatter_prefill(ours, [(torch.from_numpy(k), torch.from_numpy(v))
                               for k, v in kvs], 1,
                        torch.from_numpy(bt_row), plen, 8)
    theirs = jkv.scatter_prefill(
        jkv.init_cache(jspec), [(jnp.asarray(k), jnp.asarray(v))
                                for k, v in kvs],
        1, jnp.asarray(bt_row), plen, 8)
    first_page = 0 if bucket - plen <= 8 else 1
    assert "k_scale" not in ours  # an fp cache carries k and v only
    for key in ("k", "v"):
        for layer in range(spec.num_layers):
            np.testing.assert_array_equal(
                ours[key][layer].numpy()[first_page:],
                np.asarray(theirs[key][layer])[first_page:])
    np.testing.assert_array_equal(ours["block_tables"].numpy(),
                                  np.asarray(theirs["block_tables"]))
    np.testing.assert_array_equal(ours["seq_lens"].numpy(),
                                  np.asarray(theirs["seq_lens"]))


def test_page_schema_is_checked():
    spec = tkv.spec_for_model(tllama.llama_tiny(), block_size=8,
                              max_batch=1, max_seq=16)
    cache = tkv.init_cache(spec, "cpu")
    cache["k_scale"] = [torch.zeros(1)]
    with pytest.raises(ValueError):
        tkv.scatter_prefill(cache, [], 0, torch.zeros(2, dtype=torch.int32),
                            1, 8)


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_pair():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl="flash")
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


def _requests(mod):
    rng = np.random.default_rng(7)
    return [mod.Request("a", rng.integers(1, 500, size=5).tolist(), 6),
            mod.Request("b", rng.integers(1, 500, size=20).tolist(), 4),
            mod.Request("c", rng.integers(1, 500, size=9).tolist(), 5)]


def test_engine_streams_match_jax_engine(engine_pair):
    """Three requests of mixed length on two slots, so one waits for a
    slot: the greedy token streams are identical to the JAX engine's, and
    so is every captured prefill / decode logit row within tolerance."""
    fmodel, variables, model = engine_pair
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        async_decode="off", max_batch=2, max_seq=64, block_size=8,
        buckets=(16, 32)))
    teng = tengine.ServingEngine(model, tengine.EngineConfig(
        max_batch=2, max_seq=64, block_size=8, buckets=(16, 32)),
        device="cpu")
    jeng.capture_logits = teng.capture_logits = True
    streamed = []
    teng.on_token = lambda rid, tok: streamed.append((rid, tok))
    want = {c.rid: c for c in jeng.run(_requests(jengine))}
    got = {c.rid: c for c in teng.run(_requests(tengine))}
    assert set(got) == set(want) == {"a", "b", "c"}
    for rid, c in got.items():
        assert c.tokens == want[rid].tokens, rid
        assert c.finish_reason == want[rid].finish_reason == "length"
        assert c.prompt_len == want[rid].prompt_len
        assert [t for r, t in streamed if r == rid] == c.tokens
        rows, jrows = teng.logit_log[rid], jeng.logit_log[rid]
        assert len(rows) == len(jrows) == len(c.tokens)
        for i, (row, jrow) in enumerate(zip(rows, jrows)):
            np.testing.assert_allclose(row, np.asarray(jrow),
                                       atol=ENGINE_LOGITS_ATOL, rtol=0,
                                       err_msg=f"{rid} token {i}")
    # every slot and page came back
    assert teng._allocator.available == teng.cache_cfg.num_pages - 1
    assert not teng.has_work()
    stats = teng.stats()
    assert stats["prefills"] == 3
    assert stats["decode_tokens"] == sum(len(c.tokens) - 1
                                         for c in got.values())
    assert stats["decode_steps"] > 0 and stats["ttft_mean_ms"] > 0


def test_engine_eos_finishes_early(engine_pair):
    _, _, model = engine_pair
    cfg = tengine.EngineConfig(max_batch=2, max_seq=64, block_size=8,
                               buckets=(16, 32))
    first = tengine.ServingEngine(model, cfg, device="cpu").run(
        [tengine.Request("x", [5, 6, 7, 8], 6)])[0]
    eos = first.tokens[2]
    stop = first.tokens.index(eos) + 1
    again = tengine.ServingEngine(
        model, dataclasses.replace(cfg, eos_id=eos), device="cpu").run(
        [tengine.Request("x", [5, 6, 7, 8], 6)])[0]
    assert again.finish_reason == "eos"
    assert again.tokens == first.tokens[:stop]


def test_engine_rejects_what_the_jax_engine_rejects(engine_pair):
    _, _, model = engine_pair
    eng = tengine.ServingEngine(model, tengine.EngineConfig(
        max_batch=2, max_seq=32, block_size=8, buckets=(8, 16)),
        device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit(tengine.Request("empty", [], 4))
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(tengine.Request("too-long", list(range(1, 40)), 4))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(tengine.Request("overflow", list(range(1, 30)), 8))
    assert not eng.has_work()


def test_engine_config_matches_jax(monkeypatch):
    for k, v in {"M2KT_SERVE_MAX_BATCH": "3", "M2KT_SERVE_MAX_SEQ": "96",
                 "M2KT_KV_BLOCK_SIZE": "8", "M2KT_SERVE_BUCKETS": "16,48",
                 "M2KT_SERVE_ADMIT_BURST": "0"}.items():
        monkeypatch.setenv(k, v)
    ours, theirs = tengine.EngineConfig.from_env(), \
        jengine.EngineConfig.from_env()
    for field in ("max_batch", "max_seq", "block_size", "buckets",
                  "admit_burst", "max_new_tokens", "eos_id"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.resolved_buckets() == theirs.resolved_buckets() == (16, 48,
                                                                    96)
    assert tengine._default_buckets(200) == jengine._default_buckets(200)


def test_engine_model_on_other_device_is_refused(engine_pair):
    _, _, model = engine_pair
    with pytest.raises(ValueError):
        tengine.ServingEngine(model, tengine.EngineConfig(), device="meta")
