"""The port's prefix cache and its engine path against the JAX package's:
the trie and the refcounts, hit logits against the cache-off engine and
the JAX prefix engine, copy-on-write of shared pages (int8 scales
included), eviction under page pressure and release to zero."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import kvcache as jkv  # noqa: E402
from move2kube_tpu.serving.fleet import prefixcache as jprefix  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import kvcache as tkv  # noqa: E402
from move2kube_tpu_torch.serving import prefixcache as tprefix  # noqa: E402
from move2kube_tpu_torch.serving.quant import logit_gate  # noqa: E402

# logits, port engine vs JAX engine and vs the port's cache-off engine,
# fp32 on the CPU: the full-forward bound of tests/test_torch_llama.py
ENGINE_LOGITS_ATOL = 1e-4
# int8-kv hit rows against the int8-kv cache-off engine while the greedy
# streams agree: the JAX package's quant gate (tests/test_fleet.py)
QUANT_GATE_REL = 0.05

GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))


# ----------------------------------------------------------------------
# allocator and trie, host only
# ----------------------------------------------------------------------


def test_allocator_sharing_queries_match_jax():
    allocs = [tkv.PageAllocator(8), jkv.PageAllocator(8)]
    pages = [a.alloc(3) for a in allocs]
    assert pages[0] == pages[1]
    for a, p in zip(allocs, pages):
        assert a.reclaimable(p) == 3 and not a.is_shared(p[0])
        a.incref([p[0]])
        assert a.is_shared(p[0]) and a.reclaimable(p) == 2
        a.free([p[0]])
        assert not a.is_shared(p[0]) and a.reclaimable(p) == 3
        assert a.reclaimable([tkv.NULL_PAGE]) == 0


def _trie_script(seed: int):
    """A seeded script over a small vocabulary (so prompts share
    prefixes): inserts of donated page runs, lookups whose refs are
    dropped at once or later, evictions and a final clear."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 6, size=int(n)).tolist()
             for n in rng.integers(3, 14, size=4)]
    ops = []
    for _ in range(40):
        stem = stems[int(rng.integers(0, len(stems)))]
        toks = stem + rng.integers(1, 4, size=int(rng.integers(0, 6))).tolist()
        kind = int(rng.integers(0, 10))
        if kind < 4:
            ops.append(("insert", toks))
        elif kind < 8:
            ops.append(("lookup", toks, bool(rng.integers(0, 2))))
        elif kind < 9:
            ops.append(("evict", int(rng.integers(1, 4))))
        else:
            ops.append(("release",))
    ops.append(("clear",))
    return ops


def _drive_trie(alloc_cls, cache_cls, ops, bs=4, pool=64):
    alloc = alloc_cls(pool)
    cache = cache_cls(bs, alloc)
    held, trace = [], []
    for op in ops:
        if op[0] == "insert":
            toks = op[1]
            pages = alloc.alloc(-(-len(toks) // bs))
            if pages is None:
                trace.append(("full",))
                continue
            trace.append(("insert", cache.insert(toks, pages)))
            alloc.free(pages)  # the donor slot finishes
        elif op[0] == "lookup":
            hit = cache.lookup(op[1])
            trace.append(("lookup", None if hit is None
                          else (hit.pages, hit.covered)))
            if hit is not None:
                if op[2]:
                    held.append(hit.pages)
                else:
                    alloc.free(hit.pages)
        elif op[0] == "evict":
            trace.append(("evict", cache.evict(op[1])))
        elif op[0] == "release":
            for pages in held:
                alloc.free(pages)
            held = []
        else:
            for pages in held:
                alloc.free(pages)
            trace.append(("clear", cache.clear()))
        trace.append(("state", alloc.available, cache.total_pages,
                      len(cache),
                      sorted((p, alloc.refcount(p)) for p in range(pool))))
    trace.append(("stats", cache.stats()))
    return trace, alloc


@pytest.mark.parametrize("seed", range(6))
def test_prefix_trie_matches_jax(seed):
    """The same insert/lookup/evict script on both tries over both
    allocators returns the same hits and leaves the same refcounts after
    every call; the final clear returns every page."""
    ops = _trie_script(seed)
    ours, alloc = _drive_trie(tkv.PageAllocator, tprefix.PrefixCache, ops)
    theirs, _ = _drive_trie(jkv.PageAllocator, jprefix.PrefixCache, ops)
    assert ours == theirs
    assert any(t[0] == "lookup" and t[1] is not None for t in ours)
    assert alloc.available == 63


def test_prefix_trie_partial_pages_and_dedup():
    """tests/test_fleet.py's trie cases on the port's cache."""
    alloc = tkv.PageAllocator(33)
    cache = tprefix.PrefixCache(4, alloc)
    toks = list(range(100, 110))
    pages = alloc.alloc(3)
    assert cache.insert(toks, pages) == 3
    assert all(alloc.refcount(p) == 2 for p in pages)
    alloc.free(pages)
    hit = cache.lookup(toks)
    assert hit.covered == 10 and hit.pages == pages
    alloc.free(hit.pages)
    hit = cache.lookup(toks[:8] + [999, 998])
    assert hit.covered == 8 and hit.pages == pages[:2]
    alloc.free(hit.pages)
    hit = cache.lookup(toks[:9])  # the cached partial is longer
    assert hit.covered == 8
    alloc.free(hit.pages)
    dup = alloc.alloc(3)
    assert cache.insert(toks, dup) == 0  # existing chunks keep their pages
    alloc.free(dup)
    assert cache.lookup([1, 2, 3, 4]) is None
    assert cache.stats()["misses"] == 1
    cache.clear()
    assert alloc.available == 32 and len(cache) == 0


# ----------------------------------------------------------------------
# the engine's hit path
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def parts():
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


def _port(model, **over):
    return tengine.ServingEngine(model, tengine.EngineConfig(
        **{**GEOMETRY, **over}), device="cpu")


def _jax(fmodel, variables, **over):
    return jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **{**GEOMETRY, "async_decode": "off", **over}))


def _prefix_requests(mod, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 200, size=12).tolist()
    return [mod.Request("cold", list(shared), 4),
            mod.Request("rerun", list(shared), 4),          # full cover
            mod.Request("fork", shared[:12] + [7, 9], 4)]   # partial


def _run(eng, reqs):
    eng.capture_logits = True
    return {c.rid: c for c in eng.run(reqs)}, eng.logit_log


def test_prefix_hit_logits_match_cache_off_and_jax(parts):
    """A rerun (full-cover hit, which must COW) and a fork (shared pages,
    new tail) decode the same tokens as the cache-off engine and the JAX
    prefix engine, every logit row within ENGINE_LOGITS_ATOL of both, and
    the hit and COW counts equal the JAX engine's."""
    fmodel, variables, model = parts
    cached = _port(model, prefix_cache=True)
    got, got_log = _run(cached, _prefix_requests(tengine, 21))
    plain, plain_log = _run(_port(model), _prefix_requests(tengine, 21))
    jeng = _jax(fmodel, variables, prefix_cache=True)
    want, want_log = _run(jeng, _prefix_requests(jengine, 21))
    stats, jstats = cached.stats(), jeng.stats()
    for key in ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_cache_pages", "cow_copies", "prefix_hit_rate"):
        assert stats[key] == jstats[key], key
    assert stats["prefix_hits"] == 2 and stats["cow_copies"] >= 1
    for rid in ("cold", "rerun", "fork"):
        assert got[rid].tokens == plain[rid].tokens == want[rid].tokens
        assert len(got_log[rid]) == len(want_log[rid]) == 4
        for i, row in enumerate(got_log[rid]):
            np.testing.assert_allclose(row, plain_log[rid][i],
                                       atol=ENGINE_LOGITS_ATOL, rtol=0,
                                       err_msg=f"{rid} {i} vs cache off")
            np.testing.assert_allclose(row, np.asarray(want_log[rid][i]),
                                       atol=ENGINE_LOGITS_ATOL, rtol=0,
                                       err_msg=f"{rid} {i} vs jax")


@pytest.mark.parametrize("quant", ["off", "int8-kv"])
def test_shared_pages_are_never_written(parts, quant):
    """Pages the cache shares out are immutable: a borrowing generation
    past the shared prefix copy-on-writes, and every pool (int8 rows and
    their scales) of every shared page is byte-identical before and
    after. Dropping the cache returns every page; a double free is
    still caught."""
    _, _, model = parts
    rng = np.random.default_rng(22)
    shared = rng.integers(1, 200, size=12).tolist()
    eng = _port(model, prefix_cache=True, quant=quant)
    eng.run([tengine.Request("seed", list(shared), 2)])
    hit = eng._prefix.lookup(shared)
    assert hit is not None and hit.pages
    keys = [k for k in tkv.PAGE_KEYS if k in eng._cache]
    assert len(keys) == (4 if quant == "int8-kv" else 2)
    snap = {(k, layer, p): eng._cache[k][layer][p].clone()
            for k in keys for layer in range(len(eng._cache[k]))
            for p in hit.pages}
    eng._allocator.free(hit.pages)
    eng.run([tengine.Request("borrow", shared + [3, 5], 6)])
    assert eng.stats()["cow_copies"] >= 1
    for (k, layer, p), before in snap.items():
        assert torch.equal(eng._cache[k][layer][p], before), (k, layer, p)
    eng._prefix.clear()
    assert eng._allocator.available == eng.cache_cfg.num_pages - 1
    with pytest.raises(ValueError):
        eng._allocator.free(hit.pages)


def test_int8_kv_cow_copies_scales(parts):
    """The COW copy of an int8 page carries its row scales: the copy of
    the rerun's boundary page equals its shared original in every pool,
    scales included, at admission."""
    _, _, model = parts
    rng = np.random.default_rng(25)
    shared = rng.integers(1, 200, size=12).tolist()
    eng = _port(model, prefix_cache=True, quant="int8-kv")
    eng.run([tengine.Request("seed", list(shared), 2)])
    eng.submit(tengine.Request("rerun", list(shared), 2))
    eng._admit_pending()
    slot = next(s for s in eng._slots if s is not None)
    assert slot.prefix_hit and eng.stats()["cow_copies"] == 2
    hit = eng._prefix.lookup(shared)
    src, dst = hit.pages[-1], slot.pages[len(hit.pages) - 1]
    assert src != dst
    for key in ("k", "v", "k_scale", "v_scale"):
        for pool in eng._cache[key]:
            assert torch.equal(pool[dst], pool[src]), key
    assert eng._cache["k_scale"][0][src].abs().sum() > 0
    eng._allocator.free(hit.pages)
    eng.run([])  # the rerun finishes
    eng._prefix.clear()
    assert eng._allocator.available == eng.cache_cfg.num_pages - 1


def test_int8_kv_prefix_hit_within_quant_gate(parts):
    """int8-kv with the prefix cache: the hit rows stay within the quant
    gate of the int8-kv cache-off engine while the greedy streams agree
    (the hit feeds its suffix through dequantized context, the cold
    prefill attends over exact K/V)."""
    _, _, model = parts
    got, got_log = _run(_port(model, prefix_cache=True, quant="int8-kv"),
                        _prefix_requests(tengine, 24))
    want, want_log = _run(_port(model, quant="int8-kv"),
                          _prefix_requests(tengine, 24))
    rows = 0
    for rid in ("rerun", "fork"):
        a, b = want[rid].tokens, got[rid].tokens
        agree = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     len(a))
        for i in range(min(agree + 1, len(got_log[rid]))):
            gate = logit_gate(want_log[rid][i], got_log[rid][i])
            assert gate["max_rel_err"] < QUANT_GATE_REL, (rid, i, gate)
            rows += 1
    assert rows >= 2


def test_eviction_under_page_pressure_matches_jax(parts):
    """A small pool fills with cached prefixes; later cold admissions
    evict LRU leaves (admission beats retention). Per request, the hits,
    misses and cached pages follow the JAX engine's exactly, the streams
    are equal, and the pool comes back whole once the cache is dropped."""
    fmodel, variables, model = parts
    rng = np.random.default_rng(26)
    prompts = [rng.integers(1, 200, size=int(n)).tolist()
               for n in (20, 17, 26, 19, 23)]
    prompts.append(prompts[0][:16] + [4, 4])  # hit on the oldest, if kept
    prompts.append(list(prompts[4]))          # hit on the newest
    over = dict(prefix_cache=True, max_batch=1, max_seq=40)
    teng, jeng = _port(model, **over), _jax(fmodel, variables, **over)
    for i, p in enumerate(prompts):
        got = teng.run([tengine.Request(f"r{i}", list(p), 3)])
        want = jeng.run([jengine.Request(f"r{i}", list(p), 3)])
        assert got[0].tokens == want[0].tokens, i
        ts, js = teng.stats(), jeng.stats()
        for key in ("prefix_hits", "prefix_misses", "prefix_cache_pages",
                    "cow_copies"):
            assert ts[key] == js[key], (i, key)
        assert teng._allocator.available == jeng._allocator.available, i
    assert teng._prefix.evicted_pages > 0
    assert teng.stats()["prefix_hits"] >= 1
    teng._prefix.clear()
    assert teng._allocator.available == teng.cache_cfg.num_pages - 1


def test_short_suffix_gate_declines_long_suffixes(parts):
    """A hit whose uncached suffix is longer than ``prefix_max_suffix``
    prefills cold instead, and its lookup refs are dropped."""
    _, _, model = parts
    rng = np.random.default_rng(27)
    shared = rng.integers(1, 200, size=16).tolist()
    eng = _port(model, prefix_cache=True, prefix_max_suffix=4)
    eng.run([tengine.Request("a", list(shared), 2)])
    eng.run([tengine.Request("b", shared[:8] + [9] * 8, 2)])  # suffix 8
    eng.run([tengine.Request("c", shared + [5, 6], 2)])       # suffix 2
    stats = eng.stats()
    assert stats["prefix_hits"] == 1 and stats["prefix_misses"] == 2
    eng._prefix.clear()
    assert eng._allocator.available == eng.cache_cfg.num_pages - 1
