"""The port's drain, deadlines, request tracing and stats against the JAX
package's engine: the same requests give the same refusals, sheds,
counters, span trees and stats keys."""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.obs import tracing as jtracing  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs import tracing as ttracing  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402

GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))

# stats keys of the JAX engine's parts the port does not have yet: the
# async pipeline (4h)
UNPORTED_STATS = {"decode_substeps"}

# families the deadline / drain paths write
SHED_FAMILIES = ("m2kt_serve_deadline_shed_total", "m2kt_serve_rejected_total",
                 "m2kt_serve_completed_total", "m2kt_serve_admitted_total",
                 "m2kt_serve_tenant_admitted_total",
                 "m2kt_serve_tenant_rejected_total")


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


def _pair(parts, tracer=False, **over):
    fmodel, variables, model = parts
    cfg = {**GEOMETRY, **over}
    teng = tengine.ServingEngine(
        model, tengine.EngineConfig(**cfg, async_decode="off"), device="cpu",
        tracer=ttracing.SpanRecorder() if tracer else None)
    jeng = jengine.ServingEngine(
        fmodel, variables, jengine.EngineConfig(**cfg, async_decode="off"),
        tracer=jtracing.SpanRecorder() if tracer else None)
    return teng, jeng


def _lines(eng, families=SHED_FAMILIES):
    return sorted(line for line in eng.registry.render().splitlines()
                  if line.split("{")[0].split(" ")[0] in families)


def _prompt(seed, n=9):
    return np.random.default_rng(seed).integers(1, 200, size=n).tolist()


def test_expired_and_unmeetable_deadlines_raise_and_count(parts):
    """An expired deadline raises DeadlineExceeded at once; with decode
    history, a deadline shorter than max_new p50 steps raises as
    unmeetable; a loose one is admitted. Both engines count the same
    sheds, rejections and admissions, by reason and tenant."""
    for eng, mod in zip(_pair(parts), (tengine, jengine)):
        with pytest.raises(mod.DeadlineExceeded, match="expired"):
            eng.submit(mod.Request("late", _prompt(1), 4, tenant="acme",
                                   deadline_s=0.0))
        # no history yet: the benefit of the doubt
        eng.run([mod.Request("warm", _prompt(2), 6, deadline_s=1e-3)])
        assert eng.stats()["decode_steps"] > 0
        with pytest.raises(mod.DeadlineExceeded, match="unmeetable"):
            eng.submit(mod.Request("tight", _prompt(3), 30,
                                   deadline_s=1e-7))
        assert issubclass(mod.DeadlineExceeded, ValueError)
        eng.run([mod.Request("loose", _prompt(4), 4, tenant="acme",
                             deadline_s=600.0)])


@pytest.fixture
def shed_pair(parts):
    return _pair(parts)


def test_deadline_counters_match_jax(shed_pair):
    """The refusal sequence above, on a fresh pair: the rendered shed,
    reject, complete and admit lines are identical."""
    for eng, mod in zip(shed_pair, (tengine, jengine)):
        with pytest.raises(mod.DeadlineExceeded):
            eng.submit(mod.Request("late", _prompt(1), 4, tenant="acme",
                                   deadline_s=-1.0))
        with pytest.raises(ValueError, match="empty"):
            eng.submit(mod.Request("empty", [], 4, tenant="b"))
        eng.run([mod.Request("ok", _prompt(2), 3, tenant="acme")])
    teng, jeng = shed_pair
    assert _lines(teng) == _lines(jeng)
    assert 'm2kt_serve_deadline_shed_total{reason="expired"} 1' in _lines(
        teng)


def test_queued_expiry_completes_shed(shed_pair):
    """A request whose deadline passes while it waits for a slot
    completes "shed" with no tokens when its turn comes, without taking
    the slot; both engines agree on the completions and counters."""
    results = []
    for eng, mod in zip(shed_pair, (tengine, jengine)):
        eng.submit(mod.Request("a", _prompt(5), 4))
        eng.submit(mod.Request("b", _prompt(6), 4))
        eng.submit(mod.Request("doomed", _prompt(7), 4, deadline_s=1e-3))
        eng.step()
        time.sleep(2e-3)
        done = []
        while eng.has_work():
            done.extend(eng.step())
        results.append({c.rid: (c.finish_reason, len(c.tokens))
                        for c in done})
        assert eng.stats()["prefills"] == 2
    assert results[0] == results[1]
    assert results[0]["doomed"] == ("shed", 0)
    assert results[0]["a"] == ("length", 4)
    teng, jeng = shed_pair
    assert _lines(teng) == _lines(jeng)
    assert ('m2kt_serve_deadline_shed_total{reason="queued_expired"} 1'
            in _lines(teng))


def test_drain_refuses_new_work_and_finishes_inflight(shed_pair):
    """A draining engine raises EngineDraining on submit (before any
    validation, uncounted) while the running and queued requests finish;
    undrain admits again."""
    for eng, mod in zip(shed_pair, (tengine, jengine)):
        eng.submit(mod.Request("run", _prompt(8), 5))
        eng.submit(mod.Request("queued", _prompt(9), 5))
        eng.submit(mod.Request("waiting", _prompt(10), 5))
        eng.step()
        eng.drain()
        assert eng.draining
        with pytest.raises(mod.EngineDraining):
            eng.submit(mod.Request("new", _prompt(11), 5))
        with pytest.raises(mod.EngineDraining):
            eng.submit(mod.Request("bad", [], 5))
        assert issubclass(mod.EngineDraining, RuntimeError)
        done = eng.run([])
        assert sorted(c.rid for c in done) == ["queued", "run", "waiting"]
        assert all(c.finish_reason == "length" for c in done)
        assert not eng.has_work()
        eng.undrain()
        assert not eng.draining
        assert len(eng.run([mod.Request("after", _prompt(12), 2)])) == 1
    teng, jeng = shed_pair
    assert _lines(teng) == _lines(jeng)


# ----------------------------------------------------------------------
# request tracing
# ----------------------------------------------------------------------


def _span_tree(tracer):
    """Per request: its root's attrs of interest and its children's
    names in order (decode steps counted)."""
    spans = tracer.snapshot()
    roots = {s["span_id"]: s for s in spans if s["name"] == "serve.request"}
    tree = {r["attrs"]["rid"]: {"attrs": {k: r["attrs"].get(k) for k in (
        "prompt_len", "tenant", "finish_reason", "tokens", "shed_reason")},
        "children": [], "parent_id": r["parent_id"]}
        for r in roots.values()}
    for s in spans:
        root = roots.get(s["parent_id"])
        if root is not None:
            tree[root["attrs"]["rid"]]["children"].append(s["name"])
    return tree, roots


TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.mark.parametrize("over", [
    dict(),
    dict(prefix_cache=True),
    dict(chunk_prefill=16, max_seq=128, buckets=(16, 64)),
    dict(spec_k=2, spec_draft_factor=2),
], ids=["plain", "prefix", "chunked", "spec"])
def test_span_tree_matches_jax(parts, over):
    """Each request's serve.request root (adopting a caller's
    traceparent) and its serve.* children, in order, are the JAX
    engine's: queue wait and prefill, or the prefix install, one
    decode/spec step per emitting step, chunk spans. On the cold path the
    queue wait and the prefill sum to the TTFT the histogram saw."""
    rng = np.random.default_rng(13)
    shared = rng.integers(1, 200, size=12).tolist()
    long_p = rng.integers(1, 200, size=40).tolist()
    teng, jeng = _pair(parts, tracer=True, **over)
    for eng, mod in ((teng, tengine), (jeng, jengine)):
        reqs = [mod.Request("cold", list(shared), 4, tenant="acme",
                            traceparent=TRACEPARENT),
                mod.Request("rerun", list(shared), 3),
                mod.Request("fork", shared + [7, 9], 3, tenant="b")]
        if over.get("chunk_prefill"):
            reqs.append(mod.Request("long", list(long_p), 3))
        eng.run(reqs)
    ours, roots = _span_tree(teng.tracer)
    assert ours == _span_tree(jeng.tracer)[0]
    root = next(r for r in roots.values() if r["attrs"]["rid"] == "cold")
    assert root["trace_id"] == TRACEPARENT.split("-")[1]
    assert root["parent_id"] == "00f067aa0ba902b7"
    if not over:
        kids = {s["name"]: s for s in teng.tracer.snapshot()
                if s["parent_id"] == root["span_id"]}
        ttft = root["attrs"]["ttft_s"]
        assert (kids["serve.queue_wait"]["dur_s"]
                + kids["serve.prefill"]["dur_s"]) == pytest.approx(
                    ttft, abs=2e-6)


def test_tracing_off_records_nothing(parts, monkeypatch):
    monkeypatch.setenv("M2KT_TRACE", "0")
    _, _, model = parts
    eng = tengine.ServingEngine(model, tengine.EngineConfig(**GEOMETRY),
                                device="cpu")
    assert eng.tracer is None
    assert len(eng.run([tengine.Request("r", _prompt(14), 3)])) == 1


# ----------------------------------------------------------------------
# stats and config
# ----------------------------------------------------------------------


@pytest.mark.parametrize("over", [
    dict(),
    dict(prefix_cache=True),
    dict(spec_k=2),
    dict(chunk_prefill=16),
    dict(prefix_cache=True, quant="int8-kv", spec_k=1),
], ids=["plain", "prefix", "spec", "chunked", "stack"])
def test_stats_keys_cover_the_jax_engines(parts, over):
    """stats() carries every key the JAX engine reports for the same
    config, less those of its unported parts, and the port's own keys;
    after the same run, the shared counters agree."""
    teng, jeng = _pair(parts, **over)
    for eng, mod in ((teng, tengine), (jeng, jengine)):
        eng.run([mod.Request("a", _prompt(15, 20), 3),
                 mod.Request("b", _prompt(15, 20), 3)])
    ours, theirs = teng.stats(), jeng.stats()
    assert set(theirs) - UNPORTED_STATS <= set(ours)
    for key in ("device", "decode_time_s", "prefill_time_s", "ttft_mean_ms",
                "ttft_max_ms", "passes"):
        assert key in ours
    keys = ["decode_steps", "decode_tokens", "prefills", "queue_depth",
            "active_slots", "prefix_hits", "prefix_misses", "cow_copies",
            "chunked_prefills", "spec_proposed", "spec_accepted"]
    if over.get("chunk_prefill"):
        keys.remove("decode_tokens")  # see the test below
    for key in keys:
        assert ours.get(key) == theirs.get(key), key
    assert ours["async_decode"] is theirs["async_decode"]


def test_decode_tokens_leave_out_chunking_slots(parts):
    """decode_tokens counts the tokens decode steps produced. The JAX
    engine's synchronous step also counts a slot that is still chunking
    (it has no pending suffix), one token a step that produced none
    (a reference caveat, ROADMAP.md Queue 3); the port counts only the
    slots that decoded, so its count is the streams' own."""
    teng, jeng = _pair(parts, chunk_prefill=16)
    got = {}
    for eng, mod in ((teng, tengine), (jeng, jengine)):
        done = eng.run([mod.Request("a", _prompt(15, 20), 3),
                        mod.Request("b", _prompt(16, 20), 3)])
        got[mod] = {c.rid: c.tokens for c in done}
    assert got[tengine] == got[jengine]
    # each request's first token comes from its prefill or final chunk
    produced = sum(len(t) - 1 for t in got[tengine].values())
    assert teng.stats()["decode_tokens"] == produced == 4
    assert jeng.stats()["decode_tokens"] == produced + 2


def test_engine_config_env_matches_jax(monkeypatch):
    for k, v in {"M2KT_SERVE_PREFIX_CACHE": "on",
                 "M2KT_PREFIX_MAX_SUFFIX": "24", "M2KT_SPEC_K": "3",
                 "M2KT_SCHED_CHUNK_PREFILL": "64"}.items():
        monkeypatch.setenv(k, v)
    ours, theirs = tengine.EngineConfig.from_env(), \
        jengine.EngineConfig.from_env()
    for field in ("prefix_cache", "prefix_max_suffix", "spec_k",
                  "spec_draft_factor", "chunk_prefill"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.prefix_cache is True and ours.spec_k == 3
    monkeypatch.setenv("M2KT_SPEC_K", "-2")
    monkeypatch.setenv("M2KT_SCHED_CHUNK_PREFILL", "junk")
    assert tengine.EngineConfig.from_env().spec_k == 0
    assert tengine.EngineConfig.from_env().chunk_prefill == 0
    assert tengine.LATENCY_BUCKETS == jengine.LATENCY_BUCKETS
    assert tengine.LENGTH_BUCKETS == jengine.LENGTH_BUCKETS


def test_metrics_render_reads_no_device_state(parts):
    """The occupancy gauges re-render from the host snapshot taken at the
    last step: a scrape mid-run reports what the last step saw, and the
    tenant families carry each tenant's series."""
    _, _, model = parts
    eng = tengine.ServingEngine(model, tengine.EngineConfig(**GEOMETRY),
                                device="cpu")
    for i, tenant in enumerate(("a", "b", "c")):
        eng.submit(tengine.Request(f"r{i}", _prompt(20 + i), 3,
                                   tenant=tenant))
    eng.step()
    text = eng.registry.render()
    assert "m2kt_serve_active_slots 1\n" in text
    assert "m2kt_serve_queue_depth 2\n" in text
    eng._cache["seq_lens"] = None  # a scrape must not touch the cache
    assert eng.registry.render() == text
