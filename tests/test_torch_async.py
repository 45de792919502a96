"""The port's async decode pipeline and multi-substep decode against its
own synchronous loop and against the JAX engine's pipeline
(``move2kube_tpu/serving/engine.py``, ``async_decode="on"``), on the CPU.

The tiny Llama of ``tests/test_async.py`` (fp32, two slots, max_seq 64,
pages of 8, buckets 8 and 16) with the JAX weights carried across by
``params_from_jax``. Greedy streams are held byte for byte: across
windows of 1 and 4 passes, EOS at an interior pass of a window, a prefix
hit whose owed suffix outruns a window, preemption at the lag-1
boundary, chunked prefill, a weight swap mid-stream, the chaos kill's
journal, spec decode's fallback to the synchronous loop, the capacity
slack and int8-kv. Logits are held to the JAX engine's within
``ENGINE_LOGITS_ATOL`` (fp32) and ``INT8_LOGITS_ATOL`` (int8-kv).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs.metrics import Registry  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402

# fp32 logits, port vs JAX: the full-forward bound of
# tests/test_torch_llama.py (tests/test_torch_serving.py's)
ENGINE_LOGITS_ATOL = 1e-4
# int8-kv logits, port vs JAX: int8 rows that round the other way flip a
# code (ROADMAP Queue 3; tests/test_torch_quant.py's bound)
INT8_LOGITS_ATOL = 5e-3
GEOMETRY = dict(max_batch=2, max_seq=64, block_size=8, buckets=(8, 16))
TENANTS = "gold:prio=high;free:prio=besteffort"


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


def _pair(parts, **over):
    """The port's engine and the JAX engine, one config."""
    fmodel, variables, model = parts
    kw = {**GEOMETRY, **over}
    registry = kw.pop("registry", None)
    return (tengine.ServingEngine(model, tengine.EngineConfig(**kw),
                                  device="cpu", registry=registry),
            jengine.ServingEngine(fmodel, variables,
                                  jengine.EngineConfig(**kw)))


def _port(parts, **over):
    return tengine.ServingEngine(
        parts[2], tengine.EngineConfig(**{**GEOMETRY, **over}), device="cpu")


def _prompt(seed, plen):
    return np.random.default_rng(seed).integers(1, 200, size=plen).tolist()


def _reqs(mod):
    return [mod.Request("a", _prompt(1, 4), 6),
            mod.Request("b", _prompt(2, 9), 8),
            mod.Request("c", _prompt(3, 14), 5),
            mod.Request("d", _prompt(4, 6), 7)]


def _streams(eng, reqs):
    return {c.rid: (c.tokens, c.finish_reason) for c in eng.run(reqs)}


def _logits_close(ours, theirs, rids, atol):
    for rid in rids:
        rows, jrows = ours.logit_log[rid], theirs.logit_log[rid]
        assert len(rows) == len(jrows), rid
        for i, (row, jrow) in enumerate(zip(rows, jrows)):
            np.testing.assert_allclose(row, np.asarray(jrow), atol=atol,
                                       rtol=0, err_msg=f"{rid} token {i}")


@pytest.fixture(scope="module")
def sync_streams(parts):
    return _streams(_port(parts, async_decode="off"), _reqs(tengine))


@pytest.mark.parametrize("substeps", [1, 4])
def test_async_streams_match_sync_and_jax(parts, sync_streams, substeps):
    """Four requests on two slots (slots recycled mid-window): the
    window's streams equal the port's synchronous loop's and the JAX
    pipeline's; each token's logit row equals the JAX one's; every page
    comes back."""
    ours, theirs = _pair(parts, async_decode="on", substeps=substeps)
    assert ours.async_decode and ours.substeps == substeps
    ours.capture_logits = theirs.capture_logits = True
    journal = []
    ours.on_token = lambda rid, tok: journal.append((rid, tok))
    got = _streams(ours, _reqs(tengine))
    assert got == sync_streams == _streams(theirs, _reqs(jengine))
    for rid, (tokens, _) in got.items():
        assert [t for r, t in journal if r == rid] == tokens
    _logits_close(ours, theirs, got, ENGINE_LOGITS_ATOL)
    assert ours._allocator.available == ours.cache_cfg.num_pages - 1
    assert not ours.has_work()
    assert ours.stats()["passes"]["decode"] == substeps * ours.stats()[
        "decode_steps"]


def test_eos_at_an_interior_pass_stops_where_sync_does(parts):
    """An EOS picked from the synchronous stream so that it lands on pass
    1 or 2 of a 4-pass window: the async stream stops exactly there, the
    rest of the window is trimmed, and every page comes back."""
    req = dict(rid="a", prompt=_prompt(1, 4), max_new_tokens=12)
    ref = _port(parts, async_decode="off").run([tengine.Request(**req)])[0]
    # token k comes from pass (k - 1) % 4 of window (k - 1) // 4 + 1
    k = next(k for k in range(1, 12) if (k - 1) % 4 in (1, 2)
             and ref.tokens[k] not in ref.tokens[:k])
    eos = ref.tokens[k]
    sync = _port(parts, async_decode="off", eos_id=eos)
    ours, theirs = _pair(parts, async_decode="on", substeps=4, eos_id=eos)
    want = _streams(sync, [tengine.Request(**req)])
    assert want["a"] == (ref.tokens[:k + 1], "eos")
    assert _streams(ours, [tengine.Request(**req)]) == want
    assert _streams(theirs, [jengine.Request(**req)]) == want
    assert ours._allocator.available == ours.cache_cfg.num_pages - 1


def test_prefix_hit_suffix_longer_than_a_window(parts):
    """A prefix hit owing a 6-token suffix at 4 passes a window: the
    suffix rides two forced windows (3 owed tokens, then the rest), and
    the stream, the first token's TTFT and the hit counts equal the
    synchronous loop's and the JAX pipeline's."""
    shared = _prompt(5, 16)

    def reqs(mod):
        return [mod.Request("cold", shared + [7], 4),
                mod.Request("hit", shared + _prompt(6, 6), 6)]

    sync = _port(parts, async_decode="off", prefix_cache=True)
    want = {}
    for r in reqs(tengine):
        want.update(_streams(sync, [r]))
    ours, theirs = _pair(parts, async_decode="on", substeps=4,
                         prefix_cache=True)
    ours.capture_logits = theirs.capture_logits = True
    got, jgot = {}, {}
    for r, j in zip(reqs(tengine), reqs(jengine)):
        got.update(_streams(ours, [r]))
        jgot.update(_streams(theirs, [j]))
    assert got == want == jgot
    _logits_close(ours, theirs, got, ENGINE_LOGITS_ATOL)
    stats, jstats = ours.stats(), theirs.stats()
    assert stats["prefix_hits"] == jstats["prefix_hits"] == 1
    assert stats["prefix_hit_tokens"] == jstats["prefix_hit_tokens"] == 16
    assert ours._ttft_hist.count == 2


def test_preemption_mid_stream_matches_jax(parts):
    """A gold request preempting a best-effort stream at the lag-1
    boundary, both engines stepped alike: the completions (the victim's
    consumed tokens only) equal the JAX pipeline's, the victim's are a
    prefix of its uninterrupted stream and the survivor's equal it."""
    truth = _port(parts, async_decode="off").run(
        [tengine.Request("t", _prompt(7, 5), 12),
         tengine.Request("t2", _prompt(8, 9), 12)])
    truth = {c.rid: c.tokens for c in truth}
    runs = []
    for eng, mod in zip(_pair(parts, async_decode="on", substeps=2,
                              sched_tenants=TENANTS), (tengine, jengine)):
        eng.submit(mod.Request("be1", _prompt(7, 5), 12, tenant="free"))
        eng.submit(mod.Request("be2", _prompt(8, 9), 12, tenant="free"))
        done = []
        for _ in range(4):
            done += eng.step()
        eng.submit(mod.Request("gold", _prompt(9, 6), 2, tenant="gold"))
        while eng.has_work():
            done += eng.step()
        runs.append([(c.rid, c.tokens, c.finish_reason) for c in done])
    assert runs[0] == runs[1]
    by = {rid: (tokens, why) for rid, tokens, why in runs[0]}
    assert by["be2"][1] == "preempted" and by["be1"] == (truth["t"],
                                                         "length")
    n = len(by["be2"][0])
    assert 0 <= n < 12 and by["be2"][0] == truth["t2"][:n]
    assert len(by["gold"][0]) == 2


def test_chunked_prefill_composes_with_async(parts):
    """A 24-token prompt prefilled in chunks of 8 while a short stream
    decodes in windows of 2: both streams equal the synchronous loop's
    and the JAX pipeline's."""
    kw = dict(chunk_prefill=8, buckets=(8, 16, 64))

    def reqs(mod):
        return [mod.Request("long", _prompt(5, 24), 8),
                mod.Request("short", _prompt(6, 5), 10)]

    want = _streams(_port(parts, async_decode="off", **kw), reqs(tengine))
    ours, theirs = _pair(parts, async_decode="on", substeps=2, **kw)
    assert _streams(ours, reqs(tengine)) == want
    assert _streams(theirs, reqs(jengine)) == want
    assert ours.stats()["chunked_prefills"] == 1


def test_install_weights_mid_stream_flushes_first(parts):
    """A same-weights swap with two windows in flight: the swap consumes
    them first (nothing stays in flight), their completions come from the
    next step, and the streams and completions equal the JAX pipeline's
    under the same swap and an unswapped run's."""
    want = _streams(_port(parts, async_decode="off"), _reqs(tengine))
    runs = []
    fmodel, variables, model = parts
    for eng, mod, tree in zip(
            _pair(parts, async_decode="on", substeps=4),
            (tengine, jengine), (model.state_dict(), variables)):
        for r in _reqs(mod):
            eng.submit(r)
        done = []
        for _ in range(3):
            done += eng.step()
        assert len(eng._inflight) == 2
        assert eng.install_weights(tree, version=7) == 7
        assert not eng._inflight
        while eng.has_work():
            done += eng.step()
        runs.append([(c.rid, c.tokens, c.finish_reason, c.weights_version)
                     for c in done])
    assert runs[0] == runs[1]
    assert {rid: (t, why) for rid, t, why, _ in runs[0]} == want


def test_chaos_kill_journals_exactly_n(parts):
    """The journal callback raising at its 5th token under windows of 4:
    exactly 5 tokens were journaled on both engines, the same ones."""
    journals = []
    for eng, mod in zip(_pair(parts, async_decode="on", substeps=4),
                        (tengine, jengine)):
        journal = []

        def cb(rid, tok, journal=journal):
            journal.append((rid, tok))
            if len(journal) == 5:
                raise RuntimeError("chaos: kill at token N")

        eng.on_token = cb
        with pytest.raises(RuntimeError, match="kill at token N"):
            eng.run([mod.Request("drill", _prompt(10, 5), 12)])
        journals.append(journal)
    assert len(journals[0]) == 5 and journals[0] == journals[1]


def test_spec_decode_forces_the_sync_loop(parts, capsys):
    """Spec decode is host-synchronous: ``auto`` keeps the synchronous
    loop without a word, ``on`` warns as the JAX engine does; substeps
    above 1 without the pipeline fall back to 1 with the JAX engine's
    warning. Either way the stream equals the spec engine's."""
    auto, jauto = _pair(parts, async_decode="auto", spec_k=2)
    assert not auto.async_decode and not jauto.async_decode
    assert "WARNING" not in capsys.readouterr().out
    forced, jforced = _pair(parts, async_decode="on", spec_k=2)
    assert not forced.async_decode and not jforced.async_decode
    lines = [x for x in capsys.readouterr().out.splitlines()
             if "M2KT_ASYNC_DECODE=on is incompatible" in x]
    assert len(lines) == 2 and lines[0] == lines[1]
    off, joff = _pair(parts, async_decode="off", substeps=4)
    assert off.substeps == joff.substeps == 1
    lines = [x for x in capsys.readouterr().out.splitlines()
             if "M2KT_DECODE_SUBSTEPS>1 needs the async" in x]
    assert len(lines) == 2 and lines[0] == lines[1]
    want = _streams(_port(parts, spec_k=2), _reqs(tengine))
    assert _streams(forced, _reqs(tengine)) == want
    assert _streams(auto, _reqs(tengine)) == want


def test_stats_and_gauges_against_the_jax_engine(parts):
    """``stats()`` carries every key the JAX engine's has, with the same
    pipeline fields, window and token counts; the dispatch-gap histogram
    counts one reading a window, as the JAX one does; the in-flight gauge
    reads the windows in flight; the pipeline's gap total is at most the
    synchronous loop's."""
    ours, theirs = _pair(parts, async_decode="on", substeps=2,
                         registry=Registry())
    sync = _port(parts, async_decode="off")
    _streams(ours, _reqs(tengine))
    _streams(theirs, _reqs(jengine))
    _streams(sync, _reqs(tengine))
    stats, jstats, sstats = ours.stats(), theirs.stats(), sync.stats()
    assert set(jstats) <= set(stats)
    for key in ("async_decode", "decode_substeps", "decode_steps",
                "decode_tokens", "prefills"):
        assert stats[key] == jstats[key], key
    assert stats["async_decode"] is True and stats["decode_substeps"] == 2
    assert sstats["async_decode"] is False and "decode_substeps" not in sstats
    assert ours._dispatch_gap.count == theirs._dispatch_gap.count
    assert stats["dispatch_gap_total_s"] <= sstats["dispatch_gap_total_s"]
    assert 0.0 <= stats["host_overhead_ratio"] <= 1.0
    text = ours.registry.render()
    for name in ("m2kt_serve_dispatch_gap_seconds_count",
                 "m2kt_serve_host_overhead_ratio",
                 "m2kt_serve_inflight_windows 0"):
        assert name in text, name
    ours.submit(tengine.Request("x", _prompt(1, 4), 6))
    ours.step()
    ours.step()
    assert "m2kt_serve_inflight_windows 2" in ours.registry.render()
    while ours.has_work():
        ours.step()


@pytest.mark.parametrize("max_new,admitted", [(49, True), (50, False)])
def test_capacity_slack_rejects_what_jax_rejects(parts, max_new, admitted):
    """Windows of 4 reserve 2 * 4 - 1 = 7 positions: an 8-token prompt
    with 49 new tokens fits max_seq 64, with 50 it is refused by both
    engines, where the synchronous loop takes either."""
    prompt = _prompt(11, 8)
    ours, theirs = _pair(parts, async_decode="on", substeps=4)
    assert ours._overrun_slack == theirs._overrun_slack == 7
    outcomes = []
    for eng, mod in ((ours, tengine), (theirs, jengine)):
        try:
            eng.submit(mod.Request("r", list(prompt), max_new))
            outcomes.append(True)
        except ValueError as err:
            assert "overrun slack 7" in str(err)
            outcomes.append(False)
    assert outcomes == [admitted, admitted]
    _port(parts, async_decode="off").submit(
        tengine.Request("r", list(prompt), max_new))


def test_int8_kv_windows_match_sync_and_jax(parts):
    """int8-kv at 4 passes a window: the streams equal the port's
    synchronous int8-kv loop's and the JAX pipeline's, and the logits are
    within ``INT8_LOGITS_ATOL`` of the JAX ones."""
    want = _streams(_port(parts, async_decode="off", quant="int8-kv"),
                    _reqs(tengine))
    ours, theirs = _pair(parts, async_decode="on", substeps=4,
                         quant="int8-kv")
    ours.capture_logits = theirs.capture_logits = True
    got = _streams(ours, _reqs(tengine))
    assert got == want == _streams(theirs, _reqs(jengine))
    _logits_close(ours, theirs, got, INT8_LOGITS_ATOL)
