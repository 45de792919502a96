"""The port's fleet control plane (``serving/fleet/forecast.py``,
``autoscaler.py``, ``sim.py`` and ``capture.py``, its own copies) against
the JAX package's modules.

Under injected clocks the forecasters' forecasts, the autoscaler's
decisions and gauges, ``parse_counter_total``'s hardening cases and the
``KubeScaleActuator``'s requests (``urlopen`` stood in) equal the JAX
modules'. Simulator summaries are equal for fixed seeds; a capture built
by either side is the other's, and replays in the other's simulator to
the same result. The emitted server's autoscaler role, run against a
metrics page this test serves, exports the reference's
``m2kt_autoscale_*`` families.
"""

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from move2kube_tpu.obs import metrics as jmetrics  # noqa: E402
from move2kube_tpu.serving.fleet import autoscaler as jauto  # noqa: E402
from move2kube_tpu.serving.fleet import capture as jcap  # noqa: E402
from move2kube_tpu.serving.fleet import forecast as jfc  # noqa: E402
from move2kube_tpu.serving.fleet import sim as jsim  # noqa: E402
from move2kube_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from move2kube_tpu_torch.serving.fleet import autoscaler as tauto  # noqa: E402
from move2kube_tpu_torch.serving.fleet import capture as tcap  # noqa: E402
from move2kube_tpu_torch.serving.fleet import forecast as tfc  # noqa: E402
from move2kube_tpu_torch.serving.fleet import sim as tsim  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DAY = 86400.0
SIDES = {"jax": (jfc, jauto, jsim, jcap, jmetrics),
         "port": (tfc, tauto, tsim, tcap, tmetrics)}


def _demand(t, rng):
    return 400.0 + 300.0 * math.sin(2 * math.pi * t / DAY) \
        + 40.0 * rng.standard_normal()


def test_forecasters_agree():
    out = {}
    for side, (fc, *_rest) in SIDES.items():
        rng = np.random.default_rng(7)
        one = fc.DemandForecaster(fc.ForecastConfig(), clock=lambda: 0.0,
                                  epoch=0.0)
        per = fc.TenantDemandForecaster(clock=lambda: 0.0, max_tenants=3)
        got = []
        t = 0.0
        while t < 1.5 * DAY:
            tps = _demand(t, rng)
            one.observe(tps, t=t)
            for i, tenant in enumerate(("a", "b", "c", "d")):
                per.observe(tenant, tps * (i + 1) / 10.0, t=t)
            got.append((one.forecast(3600.0, now=t), one.seasonal(t),
                        per.forecast(600.0, now=t),
                        sorted(per.forecast_by_tenant(600.0,
                                                      now=t).items())))
            t += 1800.0
        out[side] = got
    assert out["port"] == out["jax"]


def _controller(side):
    fc, auto, _, _, metrics = SIDES[side]
    now = {"t": 0.0}
    forecaster = fc.DemandForecaster(clock=lambda: now["t"])
    counter = {"v": 0.0}
    demand = fc.CounterDemand(lambda: counter["v"], forecaster,
                              clock=lambda: now["t"], window_s=60.0)
    reg = metrics.Registry()
    scaler = auto.PredictiveAutoscaler(
        forecaster, 100.0,
        config=auto.AutoscaleConfig(interval_s=15.0, max_replicas=12,
                                    target_util=0.7, lead_time_s=30.0,
                                    down_delay_s=60.0),
        clock=lambda: now["t"], registry=reg)
    return now, counter, demand, scaler, reg


def test_autoscaler_decisions_and_gauges_agree():
    rates = [50, 50, 300, 900, 900, 900, 200, 200, 200, 200, 200, 200, 20,
             20, 20, 20, 20, 20, 20, 20]
    out = {}
    for side in SIDES:
        now, counter, demand, scaler, reg = _controller(side)
        current, decisions = 1, []
        for rate in rates:
            now["t"] += 15.0
            counter["v"] += 15.0 * rate
            demand.tick()
            current = scaler.decide(current)
            decisions.append((current, scaler.desired()))
        out[side] = (decisions, reg.render())
    assert out["port"] == out["jax"]
    assert max(d for d, _ in out["port"][0]) > 1


def test_capacity_sources_agree(monkeypatch):
    class Report:
        flops, bytes_accessed = 2.0e12, 1.0e12

    class Spec:
        peak_bf16_flops, hbm_bandwidth = 2.0e14, 1.0e12

    for report in (Report(), type("E", (), {"flops": 0,
                                           "bytes_accessed": 0})()):
        assert tauto.capacity_from_cost_report(report, Spec(), 256.0) == \
            jauto.capacity_from_cost_report(report, Spec(), 256.0)
    # the port's ServingEngine.cost_report() entries are dicts
    assert tauto.capacity_from_cost_report(
        {"flops": 2.0e12, "bytes_accessed": 1.0e12}, Spec(), 256.0) == \
        pytest.approx(256.0)

    class Engine:
        def stats(self):
            return {"decode_throughput_tokens_s": 42.0}

    for env in (None, "99"):
        if env:
            monkeypatch.setenv("M2KT_AUTOSCALE_REPLICA_TPS", env)
        assert tauto.replica_capacity_tps(Engine(), 7.0) == \
            jauto.replica_capacity_tps(Engine(), 7.0)
        assert tauto.replica_capacity_tps(None, 7.0) == \
            jauto.replica_capacity_tps(None, 7.0)


PAGES = [
    "\n".join((
        "# HELP m2kt_router_admitted_tokens_total tokens",
        "# TYPE m2kt_router_admitted_tokens_total counter",
        'm2kt_router_admitted_tokens_total{tenant="a}b"} 5 1700000000',
        'm2kt_router_admitted_tokens_total{tenant="c"} 7',
        "m2kt_router_admitted_tokens_totally_not 99",
        'm2kt_router_admitted_tokens_total{tenant="d"} not-a-number',
        'm2kt_router_admitted_tokens_total{tenant="e",x="1"} 2.5e1',
        "m2kt_router_admitted_tokens_total 9",
        "garbage line", "")),
    "",
    'm2kt_router_unused_tokens_total{tenant="c"} 3\n',
]


@pytest.mark.parametrize("page", PAGES)
def test_counter_parsing_agrees(page):
    for name in ("m2kt_router_admitted_tokens_total",
                 "m2kt_router_unused_tokens_total", "m2kt_missing"):
        assert tauto.parse_counter_total(page, name) == \
            jauto.parse_counter_total(page, name)
        assert tauto.parse_counter_by_label(page, name, "tenant") == \
            jauto.parse_counter_by_label(page, name, "tenant")


def test_kube_scale_actuator_requests_agree(tmp_path, monkeypatch):
    token, ca, ns = (tmp_path / n for n in ("token", "ca", "ns"))
    token.write_text("tok\n")
    ca.write_text("")
    ns.write_text("serving\n")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    import ssl

    monkeypatch.setattr(ssl, "create_default_context",
                        lambda cafile=None: ("ctx", cafile))
    seen = []

    class Resp:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(req, timeout=None, context=None):
        seen.append((req.full_url, req.get_method(), req.data,
                     sorted(req.header_items()), timeout, context))
        if b'"replicas": 13' in req.data:
            raise OSError("denied")
        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    results = {}
    for side, mod in (("jax", jauto), ("port", tauto)):
        for attr, path in (("TOKEN", token), ("CA", ca), ("NS", ns)):
            monkeypatch.setattr(mod.KubeScaleActuator, attr, str(path))
        act = mod.KubeScaleActuator("decode")
        start = len(seen)
        results[side] = ([act.scale_to(n) for n in (3, 13)],
                         seen[start:])
    assert results["port"] == results["jax"]
    assert results["port"][0] == [True, False]
    url, method, body = results["port"][1][0][:3]
    assert method == "PATCH" and json.loads(body) == {"spec":
                                                      {"replicas": 3}}
    assert url == ("https://10.0.0.1:6443/apis/apps/v1/namespaces/serving/"
                   "deployments/decode/scale")


def _sim_summary(sim, seed, policy):
    fleet = sim.FleetConfig()
    trace = sim.Trace(sim.TraceConfig(requests_total=20_000,
                                      user_pool=100_000, seed=seed),
                      sim.LatencyModel.synthetic())
    pol = (sim.ReactiveHPAPolicy(fleet) if policy == "reactive"
           else sim.PredictivePolicy(trace, fleet))
    out = sim.simulate(trace, fleet, pol).to_dict()
    out.pop("wall_s")
    return out


@pytest.mark.parametrize("seed,policy", [(5, "reactive"), (5, "predictive"),
                                         (6, "reactive")])
def test_simulator_summaries_agree(seed, policy):
    assert _sim_summary(tsim, seed, policy) == \
        _sim_summary(jsim, seed, policy)


def _ramp_docs():
    snaps = []
    for i in range(11):
        t = 5000.0 + 60.0 * i
        snaps.append({
            "seq": i + 1, "t_mono": t, "t_unix": t, "role": "router",
            "tenants": {
                "acme": {"admitted_tokens": 900.0 * i,
                         "unused_tokens": 10.0 * i, "requests": 15.0 * i},
                "globex": {"admitted_tokens": 300.0 * i * i,
                           "unused_tokens": 0.0, "requests": 5.0 * i}},
            "counters": {}})
    return [{"schema": "m2kt-usage/v1", "role": "router", "host": "pod-r",
             "pid": 1, "snapshots": snaps}]


def _replay(cap_mod, sim_mod, capture) -> dict:
    trace = cap_mod.CapturedTrace(capture, seed=3)
    fid = cap_mod.fidelity(capture, trace)
    out = sim_mod.compare_policies(trace=trace,
                                   fleet_cfg=sim_mod.FleetConfig())
    out.pop("wall_s")
    for pol in ("reactive", "predictive"):
        out[pol].pop("wall_s")
    return {"fidelity": fid, "compare": out}


def test_captures_replay_across_the_two_sides(tmp_path):
    docs = _ramp_docs()
    caps = {side: cap.build_capture(docs, bin_s=60.0)
            for side, (_, _, _, cap, _) in SIDES.items()}
    for cap in caps.values():
        cap.pop("captured_unix")
    assert caps["port"] == caps["jax"]
    assert caps["port"]["schema"] == "m2kt-capture/v1"
    # written by one side, loaded and replayed by the other
    jpath = jcap.write_capture(caps["jax"], str(tmp_path / "j"))
    ppath = tcap.write_capture(caps["port"], str(tmp_path / "p"))
    from_jax = tcap.load_capture(jpath)
    from_port = jcap.load_capture(ppath)
    ours = _replay(tcap, tsim, from_jax)
    theirs = _replay(jcap, jsim, from_port)
    assert ours == theirs
    assert ours["fidelity"]["rate_err"] <= 0.10


def test_chargeback_keeps_the_schema():
    docs = _ramp_docs()
    ours, ref = tcap.chargeback(docs), jcap.chargeback(docs)
    assert set(ours) == set(ref)
    assert set(ours["tenants"]) == set(ref["tenants"])
    for name, row in ref["tenants"].items():
        assert set(ours["tenants"][name]) == set(row)
        for key in ("tokens", "requests", "tpu_seconds",
                    "tpu_seconds_weighted", "attainment"):
            assert ours["tenants"][name][key] == pytest.approx(row[key])
    assert ours["accelerator"] == "h100-sxm"


def _shadow(side, monkeypatch):
    _, auto, _, _, metrics = SIDES[side]
    monkeypatch.setenv("M2KT_AUTOSCALE_METRICS_URL", "http://x/metrics")
    monkeypatch.setenv("M2KT_AUTOSCALE_INTERVAL_S", "30")
    monkeypatch.setenv("M2KT_AUTOSCALE_REPLICA_TPS", "100")
    monkeypatch.setenv("M2KT_AUTOSCALE_LEAD_S", "0")
    now, totals = {"t": 0.0}, {"a": 0.0, "b": 0.0}

    def scrape(url, timeout_s=5.0):
        totals["a"] += 30.0 * 500.0
        totals["b"] += 30.0 * 200.0
        return dict(totals)

    def sleep(s):
        now["t"] += s

    monkeypatch.setattr(auto, "scrape_tenant_admitted_tokens", scrape)
    reg = metrics.Registry()
    last = auto.run_controller(loops=12, registry=reg,
                               clock=lambda: now["t"], sleep=sleep)
    return last, reg.render()


def test_run_controller_shadow_mode_agrees(monkeypatch):
    assert _shadow("port", monkeypatch) == _shadow("jax", monkeypatch)
    last, page = _shadow("port", monkeypatch)
    assert last == 8 and "m2kt_autoscale_target_replicas 8" in page


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_autoscaler_role_exports_the_families(tmp_path):
    """The server program's autoscaler role (the template as it stands,
    with its default constants), pointed at a router page this test
    serves, runs its loop and exports the reference's families."""
    scrapes = []

    class Page(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API)
            scrapes.append(time.monotonic())
            n = len(scrapes)
            body = (f'm2kt_router_admitted_tokens_total{{tenant="a"}} '
                    f"{n * 4000}\n"
                    f'm2kt_router_admitted_tokens_total{{tenant="b"}} '
                    f"{n * 1000}\n").encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    page = ThreadingHTTPServer(("127.0.0.1", 0), Page)
    threading.Thread(target=page.serve_forever, daemon=True).start()
    script = tmp_path / "serve_gpu.py"
    script.write_text(
        (REPO / "move2kube_tpu_torch/assets/cuda/serve_gpu.py").read_text())
    metrics_port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env.update({
        "PYTHONPATH": str(REPO), "M2KT_FLEET_ROLE": "autoscaler",
        "M2KT_METRICS_PORT": str(metrics_port),
        "M2KT_AUTOSCALE_METRICS_URL":
            f"http://127.0.0.1:{page.server_address[1]}/metrics",
        "M2KT_AUTOSCALE_INTERVAL_S": "0.2", "M2KT_USAGE": "0"})
    proc = subprocess.Popen([sys.executable, str(script)], cwd=tmp_path,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        text = ""
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            if len(scrapes) >= 2:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{metrics_port}/metrics",
                            timeout=5) as resp:
                        text = resp.read().decode()
                except OSError:
                    text = ""
                if "m2kt_autoscale_tenant_forecast_tps" in text:
                    break
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.2)
    finally:
        proc.kill()
        out = proc.communicate(timeout=30)[0]
        page.shutdown()
        page.server_close()
    assert len(scrapes) >= 2, out
    assert "[m2kt] fleet autoscaler: url=" in out
    for family in ("m2kt_autoscale_target_replicas",
                   "m2kt_autoscale_forecast_tps",
                   "m2kt_autoscale_tenant_forecast_tps"):
        assert f"# TYPE {family} gauge" in text, family
    assert 'm2kt_autoscale_tenant_forecast_tps{tenant="a"}' in text
    assert sorted(os.listdir(tmp_path)) == ["serve_gpu.py"]


def test_capacity_from_the_port_engines_cost_report():
    """The roofline capacity of a replica from the port's own
    ``ServingEngine.cost_report()`` and its H100 chip row."""
    import dataclasses

    import torch

    from move2kube_tpu_torch.models.convert import init_llama
    from move2kube_tpu_torch.models.llama import llama_tiny
    from move2kube_tpu_torch.obs.costmodel import chip_spec
    from move2kube_tpu_torch.serving.engine import EngineConfig, ServingEngine

    model = init_llama(dataclasses.replace(llama_tiny(), num_layers=1),
                       seed=0, device="cpu", dtype=torch.float32)
    engine = ServingEngine(model, EngineConfig(max_batch=4, max_seq=64),
                           device="cpu")
    decode = engine.cost_report("nvidia-h100-80gb")["decode"]
    spec, assumed = chip_spec("nvidia-h100-80gb")
    assert not assumed and spec.name == "h100-sxm"
    tps = tauto.capacity_from_cost_report(decode, spec, 4.0, util=0.5)
    step_s = max(decode["flops"] / spec.peak_bf16_flops,
                 decode["bytes_accessed"] / spec.hbm_bandwidth)
    assert tps == pytest.approx(0.5 * 4.0 / step_s)
