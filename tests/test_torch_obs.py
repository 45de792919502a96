"""The port's metrics registry, request tracing and SLO ledger against the
JAX package's: the same calls give the same Prometheus text, quantiles,
spans and gauges."""

import dataclasses
import gc
import math
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.obs import metrics as jmetrics  # noqa: E402
from move2kube_tpu.obs import slo as jslo  # noqa: E402
from move2kube_tpu.obs import tracing as jtracing  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import params_from_jax  # noqa: E402
from move2kube_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from move2kube_tpu_torch.obs import slo as tslo  # noqa: E402
from move2kube_tpu_torch.obs import tracing as ttracing  # noqa: E402
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402


def _script(seed: int, max_series: int):
    """A seeded sequence of registry calls: counters, gauges and
    histograms with and without labels, a capped family pushed past its
    cap, help text that needs escaping, observations in every bucket
    and past the last edge."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(120):
        kind = rng.integers(0, 6)
        if kind == 0:
            calls.append(("counter", "m2kt_c_total", (),
                          float(rng.integers(0, 5))))
        elif kind == 1:
            calls.append(("counter", "m2kt_reason_total",
                          (str(rng.choice(["eos", "length", "shed"])),),
                          1.0))
        elif kind == 2:
            calls.append(("gauge", "m2kt_g", (),
                          float(rng.standard_normal() * 10)))
        elif kind == 3:
            calls.append(("hist", "m2kt_h_seconds", (),
                          float(rng.exponential(0.2))))
        elif kind == 4:
            calls.append(("tenant", "m2kt_tenant_seconds",
                          (f"t{rng.integers(0, 2 * max_series + 2)}",),
                          float(rng.exponential(0.05))))
        else:
            calls.append(("capped", "m2kt_capped_total",
                          (f"tenant \"{rng.integers(0, 12)}\"\n",), 1.0))
    return calls


def _apply(mod, calls, max_series):
    reg = mod.Registry()
    c = reg.counter("m2kt_c_total", "a counter\\with a backslash")
    r = reg.counter("m2kt_reason_total", "by reason", labels=("reason",))
    g = reg.gauge("m2kt_g", "a gauge\nover two lines")
    h = reg.histogram("m2kt_h_seconds", "latency",
                      buckets=(0.01, 0.05, 0.1, 0.5, 1.0))
    t = reg.histogram("m2kt_tenant_seconds", "by tenant", labels=("tenant",),
                      buckets=mod.DEFAULT_BUCKETS, max_series=max_series)
    cap = reg.counter("m2kt_capped_total", "capped", labels=("tenant",),
                      max_series=max_series)
    for kind, _, labels, value in calls:
        if kind == "counter":
            c.inc(value)
        elif kind == "gauge":
            g.set(value)
        elif kind == "hist":
            h.observe(value)
        elif kind == "tenant":
            t.labels(*labels).observe(value)
        elif kind == "capped":
            cap.labels(tenant=labels[0]).inc(value)
        else:
            r.labels(*labels).inc(value)
    return reg, h, t


@pytest.mark.parametrize("seed,max_series", [(0, 3), (1, 5), (2, 1)])
def test_registry_renders_the_same_text(seed, max_series):
    """The same calls on both registries give byte-identical exposition
    text, overflow-label capping and the dropped-series counter
    included, and the same quantiles, snapshots and totals."""
    calls = _script(seed, max_series)
    ours, h, t = _apply(tmetrics, calls, max_series)
    theirs, jh, jt = _apply(jmetrics, calls, max_series)
    text = ours.render()
    assert text == theirs.render()
    assert tmetrics.OVERFLOW_LABEL in text
    assert tmetrics.DROPPED_SERIES in text
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q), q
    snaps, jsnaps = t.snapshots(), jt.snapshots()
    assert set(snaps) == set(jsnaps)
    for key, snap in snaps.items():
        assert snap.bucket_counts == jsnaps[key].bucket_counts
        for u in (0.0, 0.3, 0.77, 1.0):
            assert snap.sample(u) == jsnaps[key].sample(u)
    for name in ("m2kt_reason_total", "m2kt_capped_total"):
        assert (ours._families[name].total()
                == theirs._families[name].total())
        assert (sorted(ours._families[name].samples())
                == sorted(theirs._families[name].samples()))


def test_registry_contract_matches_jax():
    for mod in (tmetrics, jmetrics):
        reg = mod.Registry()
        c = reg.counter("x_total", "x")
        assert reg.counter("x_total") is c  # get-or-create
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            c.inc(-1)
        lab = reg.counter("y_total", labels=("a",))
        with pytest.raises(ValueError):
            lab.inc()                      # labelled family, no labels
        with pytest.raises(ValueError):
            lab.labels("1", "2")
        hook_calls = []
        reg.add_collect_hook(lambda: hook_calls.append(1))
        reg.add_collect_hook(lambda: 1 / 0)  # a bad hook never breaks render
        assert reg.render() and hook_calls == [1]
        assert mod.Registry().render() == ""
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert tmetrics._fmt(math.inf) == jmetrics._fmt(math.inf) == "+Inf"
    assert tmetrics.default_registry() is tmetrics.default_registry()


def test_timed_window_and_window_rate_match_jax():
    clock = {"t": 0.0}
    tw = [mod.TimedWindow(10.0, max_items=5, clock=lambda: clock["t"])
          for mod in (tmetrics, jmetrics)]
    counter = {"v": 0.0}
    wr = [mod.WindowRate(lambda: counter["v"], clock=lambda: clock["t"],
                         horizon_s=30.0, max_samples=8)
          for mod in (tmetrics, jmetrics)]
    rng = np.random.default_rng(3)
    for i in range(40):
        clock["t"] += float(rng.exponential(1.5))
        counter["v"] += float(rng.integers(0, 4))
        for w in tw:
            w.append(i)
        for w in wr:
            w.sample()
        for window in (0.5, 3.0, 12.0):
            assert tw[0].window(window) == tw[1].window(window)
            assert wr[0].rate(window) == wr[1].rate(window)
        assert len(tw[0]) == len(tw[1])


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------

TRACEPARENTS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00 ",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-extra",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-1",
    "00-zzf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "garbage", "", None,
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_parse_traceparent_matches_jax(header):
    assert (ttracing.parse_traceparent(header)
            == jtracing.parse_traceparent(header))


def _trace_shape(rec, header):
    """Open a detached root under ``header`` and a context-parented
    pair, record children; return the parent structure by name."""
    root = rec.start("serve.request", attrs={"rid": "r"}, detached=True,
                     remote_parent=header)
    rec.record("serve.queue_wait", root.t0, root.t0 + 1e-3,
               trace_id=root.trace_id, parent_id=root.span_id)
    outer = rec.start("outer")
    inner = rec.start("inner")
    assert rec.current() is inner
    rec.end(inner)
    assert rec.current() is outer
    rec.end(outer)
    rec.end(root, attrs={"finish_reason": "length"})
    spans = rec.snapshot()
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"], s["parent_id"] or None),
             s["in_flight"], s["attrs"]) for s in spans], root, outer


@pytest.mark.parametrize("header", [TRACEPARENTS[0], "garbage", None])
def test_span_recorder_parents_like_jax(header):
    ours, root, outer = _trace_shape(ttracing.SpanRecorder(), header)
    theirs, jroot, jouter = _trace_shape(jtracing.SpanRecorder(), header)
    assert ours == theirs
    if header == TRACEPARENTS[0]:
        # adopted: the remote trace id, parented under the remote span
        assert root.trace_id == jroot.trace_id == header.split("-")[1]
        assert root.parent_id == "00f067aa0ba902b7"
    else:
        assert root.parent_id == "" and len(root.trace_id) == 32
    assert root.traceparent() == f"00-{root.trace_id}-{root.span_id}-01"
    assert outer.trace_id != root.trace_id  # detached: no inheritance


def test_span_ring_is_bounded_like_jax():
    for mod in (ttracing, jtracing):
        rec = mod.SpanRecorder(ring_seconds=60.0, max_spans=4)
        for i in range(10):
            rec.record(f"s{i}", 0.0, 1e9)
        assert [s["name"] for s in rec.snapshot()] == ["s6", "s7", "s8",
                                                       "s9"]
        assert rec.dropped == 6
        rec.clear()
        assert rec.snapshot() == [] and rec.dropped == 0


def test_tracing_env_and_singleton(monkeypatch):
    for value, want in (("0", False), ("off", False), ("1", True),
                        ("", True)):
        monkeypatch.setenv(ttracing.TRACE_ENV, value)
        assert ttracing.enabled() is jtracing.enabled() is want
    monkeypatch.setenv(ttracing.RING_SECONDS_ENV, "-3")
    assert ttracing.ring_seconds() == jtracing.ring_seconds()
    ttracing.reset()
    rec = ttracing.get()
    assert ttracing.get() is rec
    ttracing.reset()
    assert ttracing.get() is not rec


# ----------------------------------------------------------------------
# SLO ledger
# ----------------------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "  ", "acme", "a\tb\x00c", "x" * 100,
                                 None])
def test_clean_tenant_matches_jax(raw):
    assert tslo.clean_tenant(raw) == jslo.clean_tenant(raw)


def test_slo_tracker_exports_the_same_gauges(monkeypatch):
    monkeypatch.setenv("M2KT_OBS_MAX_TENANTS", "2")
    monkeypatch.setenv("M2KT_SLO_WINDOW_SCALE", "0.001")
    assert tslo.max_tenants() == jslo.max_tenants() == 2
    assert tslo.SLOSpec.from_env() == dataclasses.replace(
        tslo.SLOSpec(), window_scale=0.001)
    clock = {"t": 0.0}
    regs = [tmetrics.Registry(), jmetrics.Registry()]
    trackers = [tslo.SLOTracker(registry=regs[0], clock=lambda: clock["t"]),
                jslo.SLOTracker(registry=regs[1], clock=lambda: clock["t"])]
    rng = np.random.default_rng(5)
    for _ in range(60):
        clock["t"] += float(rng.exponential(0.05))
        tenant = f"t{rng.integers(0, 4)}"
        ok = bool(rng.random() > 0.2)
        ttft = float(rng.exponential(0.4))
        verdicts = [tr.record(tenant, ok=ok, ttft_s=ttft) for tr in trackers]
        assert verdicts[0] == verdicts[1]
    assert regs[0].render() == regs[1].render()
    assert trackers[0].tenants() == trackers[1].tenants()
    assert (trackers[0].fast_burn_firing()
            == trackers[1].fast_burn_firing())


# ----------------------------------------------------------------------
# the engine's families
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32)
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32)
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


def _families(text):
    return [line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")]


@pytest.mark.parametrize("over", [dict(), dict(prefix_cache=True, spec_k=2,
                                                quant="int8-kv")])
def test_engine_registers_the_reference_families(tiny_pair, over):
    """A fresh engine's /metrics holds the reference engine's family set
    (name, type and help); the weights version, the quant drift and the
    async pipeline's gauge render as the reference's do (version 1)."""
    fmodel, variables, model = tiny_pair
    cfg = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32),
               **over)
    teng = tengine.ServingEngine(model, tengine.EngineConfig(**cfg),
                                 device="cpu")
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        **cfg, async_decode="off"))
    ours, theirs = teng.registry.render(), jeng.registry.render()
    assert _families(ours) == _families(theirs)
    helps = [line for line in ours.splitlines() if line.startswith("# ")]
    assert helps == [line for line in theirs.splitlines()
                     if line.startswith("# ")]
    for fam in ("m2kt_weights_version", "m2kt_serve_quant_drift",
                "m2kt_serve_inflight_windows"):
        mine = [ln for ln in ours.splitlines() if ln.startswith(fam + " ")]
        assert mine == [ln for ln in theirs.splitlines()
                        if ln.startswith(fam + " ")], fam
    assert "\nm2kt_weights_version 1\n" in ours
    mode = ("off", "int8", "int8-kv").index(cfg.get("quant", "off"))
    assert f"\nm2kt_serve_quant_mode {mode}\n" in ours


def test_engine_is_freed_with_its_last_reference(tiny_pair):
    """The engine's collect hooks hold it weakly: dropping the last
    reference frees it (and its KV pools) at once, without the cyclic
    GC, and its registry still renders."""
    _, _, model = tiny_pair
    gc.disable()
    try:
        eng = tengine.ServingEngine(model, tengine.EngineConfig(
            max_batch=2, max_seq=64, block_size=8, prefix_cache=True,
            spec_k=1), device="cpu")
        eng.run([tengine.Request("a", list(range(1, 12)), 3)])
        reg, text = eng.registry, eng.registry.render()
        alive, pool = weakref.ref(eng), weakref.ref(eng._cache["k"][0])
        del eng
        assert alive() is None and pool() is None
        assert reg.render() == text
    finally:
        gc.enable()
