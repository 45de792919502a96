"""The port's pod-side telemetry against the JAX package's
(``move2kube_tpu/obs/``): the telemetry server's endpoints over the same
registry, tracer and ledger; the span ring's Chrome trace, OTLP lines and
flight document under one fixed clock; the usage ledger, its flush and
its standard sources; the bridges, the straggler detector and the
anomaly watchdog on the same inputs; and the fleet trace collector's
stitching and exact decomposition on the same span documents. The new
modules import nothing of JAX or the JAX package.

Hygiene: every test builds its own registries, recorders and ledgers;
env knobs go through ``monkeypatch`` and point under ``tmp_path``; exit
hooks are captured by a stand-in for ``threading._register_atexit``,
never left installed; every server is closed and every thread joined.
"""

import ast
import json
import math
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.obs import bridge as jbridge  # noqa: E402
from move2kube_tpu.obs import fleetview as jfleet  # noqa: E402
from move2kube_tpu.obs import ledger as jledger  # noqa: E402
from move2kube_tpu.obs import metrics as jmetrics  # noqa: E402
from move2kube_tpu.obs import server as jserver  # noqa: E402
from move2kube_tpu.obs import tracing as jtracing  # noqa: E402
from move2kube_tpu_torch.obs import bridge as tbridge  # noqa: E402
from move2kube_tpu_torch.obs import fleetview as tfleet  # noqa: E402
from move2kube_tpu_torch.obs import ledger as tledger  # noqa: E402
from move2kube_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from move2kube_tpu_torch.obs import server as tserver  # noqa: E402
from move2kube_tpu_torch.obs import tracing as ttracing  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "move2kube_tpu")
OBS_MODULES = ("obs/__init__.py", "obs/numerics.py", "obs/costmodel.py",
               "obs/tracing.py", "obs/server.py", "obs/bridge.py",
               "obs/ledger.py", "obs/fleetview.py", "models/train.py",
               "models/convert.py")


def _roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("module", OBS_MODULES)
def test_obs_modules_import_nothing_of_jax(module):
    path = REPO / "move2kube_tpu_torch" / module
    bad = [f"{line} imports {root}" for line, root in _roots(path)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_obs_modules_loads_no_jax():
    mods = ", ".join("move2kube_tpu_torch." + m[:-3].replace("/", ".")
                     .removesuffix(".__init__") for m in OBS_MODULES)
    code = (f"import sys, {mods}; bad = [m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ----------------------------------------------------------------------
# a fixed clock and fixed ids for both sides
# ----------------------------------------------------------------------


class FakeTime:
    """Stands in for a module's ``time``: perf_counter and monotonic
    advance 1 ms a read; time() is anchored at 1.7e9."""

    def __init__(self):
        self.t = 50.0

    def perf_counter(self):
        self.t += 0.001
        return self.t

    monotonic = perf_counter

    def time(self):
        return 1.7e9 + self.t


def _fixed(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "time", FakeTime())
        ids = iter(range(1, 10 ** 6))
        monkeypatch.setattr(mod, "_new_id",
                            lambda n, ids=ids: f"{next(ids):0{2 * n}x}")


def _span_script(mod):
    rec = mod.SpanRecorder(ring_seconds=600.0, max_spans=64, host="h0",
                           slice_id=3, role="decode")
    with rec.span("serve.request", attrs={"tenant": "gold", "n": 3}) as root:
        child = rec.start("serve.prefill", attrs={"bucket": 64})
        rec.end(child, attrs={"ok": True, "ratio": 0.5})
        rec.annotate(root, done=False)
    rec.record("serve.decode_step", 50.1, 50.125,
               attrs={"token_index": 1}, trace_id=root.trace_id,
               parent_id=root.span_id)
    rec.start("serve.request", remote_parent=(
        "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"))  # left in flight
    return rec


def test_span_exports_match_the_reference(monkeypatch):
    _fixed(monkeypatch, ttracing, jtracing)
    ours, theirs = _span_script(ttracing), _span_script(jtracing)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.chrome_trace() == theirs.chrome_trace()
    assert ours.otlp_lines() == theirs.otlp_lines()
    for limit in (None, 2, 0):
        assert ours.ring_doc(limit) == theirs.ring_doc(limit)
    assert ours.ring_doc(2)["truncated"] == 2


def test_flush_ring_and_its_exit_hook(monkeypatch, tmp_path):
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "f.json"))
    assert ttracing.flight_path() == jtracing.flight_path()
    assert ttracing.ring_path() == jtracing.ring_path() == str(
        tmp_path / "f.json.ring")
    monkeypatch.delenv("M2KT_FLIGHT_PATH")
    monkeypatch.setenv("M2KT_METRICS_DIR", str(tmp_path / "m"))
    assert ttracing.flight_path() == jtracing.flight_path() == str(
        tmp_path / "m" / "m2kt-flight.json")
    monkeypatch.setenv("M2KT_FLIGHT_PATH", str(tmp_path / "f.json"))
    _fixed(monkeypatch, ttracing, jtracing)
    for mod, name in ((ttracing, "port"), (jtracing, "jax")):
        path = str(tmp_path / f"{name}.ring")
        assert _span_script(mod).flush_ring(path) == path
    ours = json.loads((tmp_path / "port.ring").read_text())
    theirs = json.loads((tmp_path / "jax.ring").read_text())
    assert ours == theirs
    hooks = []
    monkeypatch.setattr(threading, "_register_atexit", hooks.append)
    monkeypatch.setattr(ttracing, "_flush_installed", False)
    monkeypatch.setattr(ttracing, "_recorder", _span_script(ttracing))
    monkeypatch.setenv("M2KT_TRACE", "0")
    ttracing.install_ring_flush()
    assert hooks == []
    monkeypatch.setenv("M2KT_TRACE", "1")
    ttracing.install_ring_flush()
    ttracing.install_ring_flush()
    assert len(hooks) == 1
    hooks[0]()
    assert json.loads((tmp_path / "f.json.ring").read_text())["spans"]


# ----------------------------------------------------------------------
# the telemetry server
# ----------------------------------------------------------------------


def _fill(reg):
    reg.counter("m2kt_requests_total", "requests", labels=("route",)
                ).labels("a").inc(3)
    reg.gauge("m2kt_depth", "queue depth").set(2.5)
    h = reg.histogram("m2kt_lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 3.0):
        h.observe(v)
    return reg


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _ledger(mod, clock):
    led = mod.UsageLedger(clock=clock, interval_s=5.0, max_snapshots=4,
                          role="decode", host="h0")
    led.add_source(lambda: {"tenants": {"gold": {"requests": 2.0}},
                            "counters": {"admitted": 4.0}}, "s")
    for _ in range(3):
        led.snapshot()
    return led


def _serve(mod, tracer, ledger, profile_dir, readiness):
    return mod.TelemetryServer(
        port=0, registry=_fill(
            (tmetrics if mod is tserver else jmetrics).Registry()),
        profile_dir=profile_dir, readiness=readiness, tracer=tracer,
        ledger=ledger).start()


def _strip(doc):
    return {k: v for k, v in doc.items() if k != "written_unix"}


def test_server_endpoints_answer_as_the_reference(monkeypatch, tmp_path):
    _fixed(monkeypatch, ttracing, jtracing)
    monkeypatch.setattr(tledger, "time", FakeTime())
    monkeypatch.setattr(jledger, "time", FakeTime())
    states = iter(["starting", "starting", "serving", "serving"])
    servers = [_serve(mod, _span_script(tr), _ledger(led, FakeTime().
                                                     monotonic),
                      str(tmp_path / name), lambda: next(states))
               for mod, tr, led, name in (
                   (tserver, ttracing, tledger, "port"),
                   (jserver, jtracing, jledger, "jax"))]
    try:
        base = [f"http://127.0.0.1:{s.port}" for s in servers]
        for path in ("/metrics", "/healthz", "/readyz", "/readyz",
                     "/nope", "/traces?limit=x", "/traces?limit=2",
                     "/usage?window=x", "/usage", "/usage?window=0.0025",
                     "/profile?seconds=x", "/profile?seconds=0",
                     "/profile?seconds=1000", "/traces?clear=1",
                     "/traces"):
            ours, theirs = (_get(b + path) for b in base)
            if ours[2].startswith("{"):
                assert ours[:2] == theirs[:2], path
                assert _strip(json.loads(ours[2])) == _strip(
                    json.loads(theirs[2])), path
            else:
                assert ours == theirs, path
        assert json.loads(_get(base[0] + "/traces")[2])["spans"] == []
        for srv in servers:
            srv.set_ledger(None)
            srv.set_readiness(lambda: 1 / 0)
            srv.set_tracer(None)
        monkeypatch.setenv("M2KT_TRACE", "0")
        for path in ("/usage", "/readyz", "/traces"):
            ours, theirs = (_get(b + path) for b in base)
            assert ours == theirs, path
    finally:
        for srv in servers:
            srv.close()
            srv._thread.join(10)
    assert not any(s._thread.is_alive() for s in servers)


def test_profile_endpoint_writes_a_torch_profiler_trace(tmp_path):
    srv = tserver.TelemetryServer(port=0, registry=tmetrics.Registry(),
                                  profile_dir=str(tmp_path / "prof")).start()
    try:
        code, _, body = _get(f"http://127.0.0.1:{srv.port}"
                             "/profile?seconds=0.2")
    finally:
        srv.close()
        srv._thread.join(10)
    assert code == 200, body
    assert json.loads(body) == {"profile_dir": str(tmp_path / "prof"),
                                "seconds": 0.2}
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(
        traces[0].read_text())


def test_server_env_resolution(monkeypatch):
    monkeypatch.setenv("M2KT_TRACE_RING_SECONDS", "30")
    assert tserver.default_trace_limit() == jserver.default_trace_limit()
    for raw in ("", "0", "9100", "garbage"):
        monkeypatch.setenv(tserver.METRICS_PORT_ENV, raw)
        for default in (0, 9090):
            assert tserver.metrics_port_from_env(default) == (
                jserver.metrics_port_from_env(default))
    monkeypatch.setenv(tserver.METRICS_PORT_ENV, "0")
    assert tserver.start_telemetry_server() is None
    assert (tserver.METRICS_PORT_ENV, tserver.PROFILE_DIR_ENV,
            tserver.DEFAULT_METRICS_PORT) == (
        jserver.METRICS_PORT_ENV, jserver.PROFILE_DIR_ENV,
        jserver.DEFAULT_METRICS_PORT)
    busy = tserver.start_telemetry_server(port=0)
    try:
        # a busy port never kills the run
        assert tserver.start_telemetry_server(port=busy.port) is None
    finally:
        busy.close()
        busy._thread.join(10)


# ----------------------------------------------------------------------
# the usage ledger
# ----------------------------------------------------------------------


def _hist_source(mod):
    snap = mod.HistogramSnapshot((0.1, 1.0, math.inf), (1, 2, 1), 4.2, 4)

    def read():
        return {"tenants": {"gold": {"ttft": jledger.hist_doc(snap)},
                            "bronze": {"requests": 1.0}},
                "counters": {"preempted": 2.0}, "weights_version": 3}

    return read


def _ledger_script(mod, metrics, clock):
    reg = metrics.Registry()
    led = mod.UsageLedger(clock=clock, interval_s=10.0, max_snapshots=3,
                          registry=reg, role="prefill", host="h1")
    led.add_source(_hist_source(metrics), "hist")
    led.add_source(lambda: {"tenants": {"gold": {"requests": 5.0}}}, "n")
    led.add_source(lambda: 1 / 0, "broken")
    taken = []
    for t in (0.0, 4.0, 10.0, 15.0, 21.0, 33.0):
        taken.append(led.maybe_snapshot(t=t) is not None)
    return led, reg, taken


def test_usage_ledger_matches_the_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(tledger, "time", FakeTime())
    monkeypatch.setattr(jledger, "time", FakeTime())
    ours, oreg, otaken = _ledger_script(tledger, tmetrics,
                                        FakeTime().monotonic)
    theirs, jreg, jtaken = _ledger_script(jledger, jmetrics,
                                          FakeTime().monotonic)
    assert otaken == jtaken == [True, False, True, False, True, True]
    assert ours.snapshots() == theirs.snapshots()
    assert len(ours) == len(theirs) == 3
    assert ours.window(15.0, now=33.0) == theirs.window(15.0, now=33.0)
    assert _strip(ours.doc()) == _strip(theirs.doc())
    assert oreg.render() == jreg.render()
    assert ours.snapshots()[-1]["errors"] == ["broken: division by zero"]
    for led, name in ((ours, "port"), (theirs, "jax")):
        assert led.flush(str(tmp_path / f"{name}.jsonl"))
    for path in ("port", "jax"):
        a = tledger.load_jsonl(str(tmp_path / f"{path}.jsonl"))
        b = jledger.load_jsonl(str(tmp_path / f"{path}.jsonl"))
        assert _strip(a) == _strip(b)
        assert a["snapshots"] == ours.snapshots()
    doc = ours.snapshots()[-1]["tenants"]["gold"]["ttft"]
    snap, jsnap = tledger.hist_from_doc(doc), jledger.hist_from_doc(doc)
    assert isinstance(snap, tmetrics.HistogramSnapshot)
    assert (snap.buckets, snap.bucket_counts, snap.sum, snap.count) == (
        jsnap.buckets, jsnap.bucket_counts, jsnap.sum, jsnap.count)
    assert snap.buckets[-1] == math.inf
    assert snap.quantile(0.5) == jsnap.quantile(0.5)
    assert tledger.hist_doc(snap) == jledger.hist_doc(jsnap) == doc


class _Engine:
    """A stand-in carrying the families ``engine_source`` reads, on one
    side's registry."""

    def __init__(self, metrics):
        reg = metrics.Registry()
        self.weights_version = 4
        self._gauge_snapshot = {"slot_occupancy": 0.75, "queue_depth": 2.0,
                                "active_slots": 6.0}
        for attr, name in (("_sched_preempted", "p"), ("_admitted", "a"),
                           ("_rejected", "r")):
            setattr(self, attr, reg.counter(f"m2kt_{name}_total", name))
        self._admitted.inc(7)
        self._sched_preempted.inc(1)
        self._decode_tokens = 123  # an int, as both engines keep it
        self._tenant_admitted = reg.counter("m2kt_ta_total", "ta",
                                            labels=("tenant",))
        self._tenant_admitted.labels("gold").inc(5)
        self._tenant_ttft = reg.histogram("m2kt_tt_seconds", "tt",
                                          labels=("tenant",),
                                          buckets=(0.1, 1.0))
        for v in (0.05, 0.3):
            self._tenant_ttft.labels("gold").observe(v)
        self.slo = None


class _Router:
    def __init__(self, metrics):
        reg = metrics.Registry()
        self._admitted_tokens = reg.counter("m2kt_at_total", "at",
                                            labels=("tenant",))
        self._admitted_unused = reg.counter("m2kt_au_total", "au",
                                            labels=("tenant",))
        self._admitted_tokens.labels("gold").inc(100)
        self._admitted_tokens.labels("bronze").inc(40)
        self._admitted_unused.labels("gold").inc(30)

    def admitted_tokens(self):
        return (self._admitted_tokens.total()
                - self._admitted_unused.total())


def test_standard_sources_match_the_reference():
    assert tledger.engine_source(_Engine(tmetrics))() == (
        jledger.engine_source(_Engine(jmetrics))())
    assert tledger.router_source(_Router(tmetrics))() == (
        jledger.router_source(_Router(jmetrics))())
    assert tledger.router_source(_Router(tmetrics))()["counters"] == {
        "admitted_tokens_net": 110.0}


def test_engine_source_reads_a_port_engine():
    import dataclasses

    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.models.llama import llama_tiny
    from move2kube_tpu_torch.serving import engine as tengine

    model = init_llama(dataclasses.replace(llama_tiny(), num_layers=1),
                       seed=0, device="cpu", dtype=torch.float32)
    eng = tengine.ServingEngine(
        model, tengine.EngineConfig(max_batch=2, max_seq=32, block_size=8),
        device="cpu", tracer=ttracing.SpanRecorder())
    eng.run([tengine.Request("a", [1, 2, 3], 4, tenant="gold")])
    snap = tledger.engine_source(eng)()
    assert snap["weights_version"] == 1
    assert snap["counters"]["admitted"] == 1.0
    gold = snap["tenants"]["gold"]
    assert gold["requests"] == 1.0 and gold["ttft"]["count"] == 1
    assert gold["decode_tokens"]["sum"] == 4.0
    assert gold["attainment"] == 1.0


def test_install_usage_flush(monkeypatch, tmp_path):
    monkeypatch.setenv("M2KT_USAGE_PATH", str(tmp_path / "u.jsonl"))
    assert tledger.usage_path() == jledger.usage_path()
    hooks = []
    monkeypatch.setattr(threading, "_register_atexit", hooks.append)
    monkeypatch.setattr(tledger, "_flush_installed", False)
    led = tledger.UsageLedger(interval_s=60.0)
    monkeypatch.setenv("M2KT_USAGE", "off")
    assert not tledger.enabled()
    tledger.install_usage_flush(led)
    assert hooks == []
    monkeypatch.setenv("M2KT_USAGE", "1")
    tledger.install_usage_flush(led)
    tledger.install_usage_flush(led)
    assert len(hooks) == 1
    hooks[0]()
    doc = tledger.load_jsonl(str(tmp_path / "u.jsonl"))
    assert len(doc["snapshots"]) == 1 and doc["schema"] == jledger.SCHEMA
    led.start()
    led.close()
    led._thread.join(10)
    assert not led._thread.is_alive()


# ----------------------------------------------------------------------
# bridges, straggler scores, the watchdog
# ----------------------------------------------------------------------


class _Trace:
    def to_dict(self):
        return {"spans": {"plan": 1.5, "translate": 0.25},
                "counters": {"files": 12}}


class _Goodput:
    def report(self):
        return {"goodput_fraction": 0.9, "seconds": {"productive": 90.0,
                                                     "compile": 10.0},
                "steps_done": 40, "last_saved_step": 30}


def test_mirrors_and_hooks_match_the_reference():
    treg, jreg = tmetrics.Registry(), jmetrics.Registry()
    tbridge.mirror_goodput(_Goodput().report(), treg)
    jbridge.mirror_goodput(_Goodput().report(), jreg)
    tbridge.mirror_trace(treg, _Trace())
    jbridge.mirror_trace(jreg, _Trace())
    assert treg.render() == jreg.render()
    empty = tmetrics.Registry()
    tbridge.mirror_trace(empty)
    assert empty.render() == ""
    treg, jreg = tmetrics.Registry(), jmetrics.Registry()
    tbridge.install_goodput_hook(_Goodput(), treg)
    jbridge.install_goodput_hook(_Goodput(), jreg)
    tbridge.install_trace_hook(treg, _Trace())
    text = treg.render()
    assert "m2kt_goodput_fraction 0.9" in text
    assert 'm2kt_trace_span_seconds_total{span="plan"} 1.5' in text
    assert jreg.render() in text.replace(
        "".join(line + "\n" for line in text.splitlines()
                if "m2kt_trace_" in line), "")


def test_straggler_scores_match_the_reference():
    rng = np.random.default_rng(5)
    treg, jreg = tmetrics.Registry(), jmetrics.Registry()
    ours = tbridge.StragglerDetector(treg, threshold=1.4, window=8)
    theirs = jbridge.StragglerDetector(jreg, threshold=1.4, window=8)
    for step in range(40):
        for host in ("h0", "h1", "h2", "h3"):
            slow = 2.0 if host == "h2" and 10 <= step < 25 else 1.0
            t = float(rng.uniform(0.9, 1.1) * slow)
            ours.report(host, step, t)
            theirs.report(host, step, t)
            assert ours.scores() == theirs.scores()
    assert ours.events == theirs.events == 1
    assert treg.render() == jreg.render()


class _SLO:
    def __init__(self, pattern):
        self.pattern = iter(pattern)

    def fast_burn_firing(self):
        return next(self.pattern)


def _watchdog(mod, metrics, out_dir):
    clock = FakeTime()
    reg = metrics.Registry()
    dog = mod.DiagWatchdog(
        registry=reg, slo=_SLO([False, True, True, False, True] + [False]
                               * 200), out_dir=str(out_dir),
        min_interval_s=0.0, profile_seconds=0.0, max_captures=3,
        short_window=4, baseline_window=8, min_baseline=8,
        clock=clock.monotonic)
    fired = []
    for i in range(30):
        fired.append(dog.observe_step(3.0 if 16 <= i < 22 else 1.0))
        if i in (5, 6, 25):
            fired.append(dog.note_nonfinite())
    dog.wait()
    return dog, reg, fired


def test_watchdog_triggers_as_the_reference(tmp_path):
    ours, oreg, ofired = _watchdog(tbridge, tmetrics, tmp_path / "port")
    theirs, jreg, jfired = _watchdog(jbridge, jmetrics, tmp_path / "jax")
    assert [None if f is None else os.path.basename(f) for f in ofired] == (
        [None if f is None else os.path.basename(f) for f in jfired])
    assert [os.path.basename(c) for c in ours.captures] == [
        os.path.basename(c) for c in theirs.captures]
    assert len(ours.captures) == 3
    assert oreg.render() == jreg.render()
    for bundle in ours.captures:
        manifest = json.loads((Path(bundle) / "manifest.json").read_text())
        jmanifest = json.loads((tmp_path / "jax" / os.path.basename(bundle)
                                / "manifest.json").read_text())
        manifest.pop("captured_unix")
        jmanifest.pop("captured_unix")
        assert manifest == jmanifest
    assert not any(t.is_alive() for t in ours._threads + theirs._threads)
    assert (tbridge.DIAG_ENV, tbridge.DIAG_DIR_ENV) == (
        jbridge.DIAG_ENV, jbridge.DIAG_DIR_ENV)


def test_watchdog_bundle_profiles_with_torch(tmp_path):
    rec = ttracing.SpanRecorder(host="h0")
    rec.record("train.step", 1.0, 1.5)
    dog = tbridge.DiagWatchdog(registry=tmetrics.Registry(), tracer=rec,
                               out_dir=str(tmp_path), profile_seconds=0.1)
    bundle = dog.note_nonfinite()
    dog.wait()
    manifest = json.loads((Path(bundle) / "manifest.json").read_text())
    assert manifest["parts"] == ["traces.json", "profile"], manifest
    assert list((Path(bundle) / "profile").glob("*.json"))


def test_diag_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("M2KT_DIAG", "off")
    assert tbridge.diag_enabled() is jbridge.diag_enabled() is False
    monkeypatch.setenv("M2KT_METRICS_DIR", str(tmp_path))
    monkeypatch.delenv("M2KT_DIAG_DIR", raising=False)
    assert tbridge.diag_dir() == jbridge.diag_dir()
    monkeypatch.setenv("M2KT_DIAG_DIR", str(tmp_path / "d"))
    assert tbridge.diag_dir() == jbridge.diag_dir() == str(tmp_path / "d")


# ----------------------------------------------------------------------
# the fleet trace collector
# ----------------------------------------------------------------------

TID = "ab" * 16


def _span(name, sid, parent, ts, dur, **attrs):
    return {"name": name, "trace_id": TID, "span_id": sid,
            "parent_id": parent, "ts_unix": ts, "dur_s": dur,
            "in_flight": False, "attrs": dict(attrs)}


def _fleet_docs(skew):
    router = {"host": "a", "pid": 11, "role": "router", "spans": [
        _span("router.request", "r1", "", 1000.0, 0.050),
        _span("router.queue", "q1", "r1", 1000.001, 0.001),
        _span("router.call", "c1", "r1", 1000.003, 0.020, hop="prefill"),
        _span("router.call", "c2", "r1", 1000.025, 0.020, hop="decode"),
    ]}
    prefill = {"host": "b", "pid": 22, "role": "prefill", "spans": [
        _span("prefill.request", "p1", "c1", 1000.005 + skew, 0.012)]}
    decode = {"host": "c", "pid": 33, "role": "decode", "spans": [
        _span("serve.request", "s1", "c2", 1000.027 - skew, 0.015),
        _span("serve.decode_step", "s2", "s1", 1000.030 - skew, 0.004)]}
    return [router, prefill, decode]


@pytest.mark.parametrize("skew", [0.0, 2.5, -7.125])
def test_collector_stitches_and_decomposes_as_the_reference(skew):
    docs = _fleet_docs(skew)
    ours = tfleet.FleetTraceCollector(sources=docs)
    theirs = jfleet.FleetTraceCollector(sources=docs)
    assert ours.collect() == theirs.collect()
    assert ours.stitch() == theirs.stitch()
    d, jd = ours.decompose(TID), theirs.decompose(TID)
    assert d == jd
    assert abs(d["residual_s"]) < 1e-9
    assert [p["kind"] for p in d["parts"]] == [
        "gap", "child", "gap", "hop", "remote", "hop", "gap", "hop",
        "remote", "hop", "gap"]
    assert ours.chrome_trace() == theirs.chrome_trace()
    assert ours.otlp_lines() == theirs.otlp_lines()
    with pytest.raises(ValueError):
        ours.decompose("ff" * 16)


def test_collector_pulls_live_recorders_and_skips_dead_sources(monkeypatch):
    _fixed(monkeypatch, ttracing)
    rec = _span_script(ttracing)
    col = tfleet.FleetTraceCollector(
        sources=[rec, "http://127.0.0.1:1/nope"], timeout_s=0.2)
    docs = col.collect()
    assert len(docs) == 1 and docs[0]["role"] == "decode"
    col.add_source(_fleet_docs(0.0)[0])
    assert len(col.collect()) == 2
