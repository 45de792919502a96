"""Predictive SLO-driven autoscaler: forecast demand -> target replicas.

The port's own copy of ``move2kube_tpu/serving/fleet/autoscaler.py``, on
the port's obs modules, with the same names, keys and metric families.

The control loop the telemetry plane was built for (ROADMAP item 2):

1. a :class:`~move2kube_tpu_torch.serving.fleet.forecast.DemandForecaster`
   predicts the admitted-token rate at ``now + lead``, where the lead
   is the measured cold-join time of a new replica — the kernel-cache prewarm
   speedup is spent here as scale-up reaction time;
2. the forecast divides by per-replica capacity (measured decode
   tok/s from the engine's own stats, an env override, or the
   costmodel's roofline tok/s for the compiled executable) at a target
   utilization to give the replica count;
3. hysteresis keeps the answer calm: scale-up applies immediately
   (late capacity is an SLO burn, early capacity is only money),
   scale-down waits for the target to hold below the current size for
   a delay window, and shrink goes through the engine's ``drain()`` path
   so no stream is ever dropped by a scaling decision.

Two actuation backends share the controller: :class:`FleetActuator`
grows/shrinks an in-process fleet (tests, bench live smoke), and
:func:`run_controller` is the emitted controller Deployment's main
loop — it scrapes the router's ``/metrics`` page, exports the
``m2kt_autoscale_*`` gauges, and (when RBAC allows and the knob is on)
patches the decode Deployment's scale subresource. The emission side
is deliberately observe-first: with actuation off it is a shadow
controller whose gauges can be compared against the reactive HPA
before anyone hands it the keys. ``fleet_wiring`` suppresses the
reactive HPAs whenever this controller is enabled so the two loops
never duel over the same Deployment.

Stdlib-only imports at module top (vendored into emitted images);
engine-touching pieces stay behind the in-process actuator's factory.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass

from move2kube_tpu_torch.obs.metrics import Registry, default_registry
from move2kube_tpu_torch.serving.fleet.forecast import (
    CounterDemand, DemandForecaster, TenantCounterDemand,
    TenantDemandForecaster)

log = logging.getLogger("move2kube_tpu_torch.autoscaler")

ENABLE_ENV = "M2KT_AUTOSCALE"
INTERVAL_ENV = "M2KT_AUTOSCALE_INTERVAL_S"
MIN_ENV = "M2KT_AUTOSCALE_MIN"
MAX_ENV = "M2KT_AUTOSCALE_MAX"
UTIL_ENV = "M2KT_AUTOSCALE_TARGET_UTIL"
LEAD_ENV = "M2KT_AUTOSCALE_LEAD_S"
DOWN_DELAY_ENV = "M2KT_AUTOSCALE_DOWN_DELAY_S"
REPLICA_TPS_ENV = "M2KT_AUTOSCALE_REPLICA_TPS"
# controller-Deployment wiring (emission role only)
METRICS_URL_ENV = "M2KT_AUTOSCALE_METRICS_URL"
TARGET_ENV = "M2KT_AUTOSCALE_TARGET"
ACTUATE_ENV = "M2KT_AUTOSCALE_ACTUATE"

ADMITTED_COUNTER = "m2kt_router_admitted_tokens_total"
UNUSED_COUNTER = "m2kt_router_admitted_tokens_unused_total"


def _float_env(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %g", name, raw, default)
        return default


def _int_env(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("%s=%r is not an integer; using %d", name, raw, default)
        return default


@dataclass(frozen=True)
class AutoscaleConfig:
    """Controller knobs; every field has an ``M2KT_AUTOSCALE_*`` env
    override with tolerant parsing (warn + default, never crash — the
    fleet_wiring contract)."""

    interval_s: float = 15.0      # control-loop period
    min_replicas: int = 1
    max_replicas: int = 8
    target_util: float = 0.7      # fraction of capacity demand may fill
    lead_time_s: float = 120.0    # forecast horizon = cold-join time
    down_delay_s: float = 120.0   # target must hold low this long

    @classmethod
    def from_env(cls) -> "AutoscaleConfig":
        return cls(
            interval_s=max(0.1, _float_env(INTERVAL_ENV, cls.interval_s)),
            min_replicas=max(1, _int_env(MIN_ENV, cls.min_replicas)),
            max_replicas=max(1, _int_env(MAX_ENV, cls.max_replicas)),
            target_util=min(1.0, max(
                0.05, _float_env(UTIL_ENV, cls.target_util))),
            lead_time_s=max(0.0, _float_env(LEAD_ENV, cls.lead_time_s)),
            down_delay_s=max(
                0.0, _float_env(DOWN_DELAY_ENV, cls.down_delay_s)),
        )


def autoscale_enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "").strip() in ("1", "true", "on")


# ---------------------------------------------------------------------------
# per-replica capacity
# ---------------------------------------------------------------------------

def capacity_from_cost_report(report, spec, tokens_per_step: float,
                              util: float = 1.0) -> float | None:
    """Roofline tok/s of one replica from the costmodel's per-executable
    numbers: the decode step can go no faster than both the compute time
    (flops / peak) and the HBM time (bytes / bandwidth), so the
    achievable step rate is 1 / max(...) and tok/s follows from the
    tokens one step advances. Returns None when the report is degraded
    (CPU backends often report no cost analysis)."""
    if isinstance(report, dict):
        # an entry of the port's ``ServingEngine.cost_report()``
        flops, bytes_accessed = (report.get("flops"),
                                 report.get("bytes_accessed"))
    else:
        flops = getattr(report, "flops", None)
        bytes_accessed = getattr(report, "bytes_accessed", None)
    if not flops or not bytes_accessed or tokens_per_step <= 0:
        return None
    step_s = max(flops / spec.peak_bf16_flops,
                 bytes_accessed / spec.hbm_bandwidth)
    if step_s <= 0:
        return None
    return (tokens_per_step / step_s) * min(1.0, max(0.0, util))


def replica_capacity_tps(engine=None, default: float = 100.0) -> float:
    """Sustainable decode tok/s of ONE replica, best source first:
    the ``M2KT_AUTOSCALE_REPLICA_TPS`` override, the engine's own
    measured ``decode_throughput_tokens_s``, then the default. Always
    positive — a zero capacity would divide the controller by it."""
    override = _float_env(REPLICA_TPS_ENV, 0.0)
    if override > 0:
        return override
    if engine is not None:
        try:
            measured = float(
                engine.stats().get("decode_throughput_tokens_s") or 0.0)
            if measured > 0:
                return measured
        except Exception:  # noqa: BLE001 - stats are advisory
            pass
    return max(1e-6, default)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class PredictiveAutoscaler:
    """Forecast -> target-replica controller with asymmetric hysteresis.

    Pure decision logic plus gauges; actuation is the caller's problem
    (FleetActuator in-process, the scale subresource in emission, a
    capacity-change event in the simulator). ``capacity_tps`` may be a
    number or a zero-arg callable re-read every decision, so a live
    fleet's measured throughput keeps the controller honest."""

    def __init__(self, forecaster: DemandForecaster, capacity_tps,
                 config: AutoscaleConfig | None = None,
                 clock=time.monotonic,
                 registry: Registry | None = None) -> None:
        self.forecaster = forecaster
        self._capacity = capacity_tps
        self.config = config or AutoscaleConfig.from_env()
        self._clock = clock
        self._below_since: float | None = None
        reg = registry or default_registry()
        self._g_target = reg.gauge(
            "m2kt_autoscale_target_replicas",
            "Replica count the predictive controller wants right now")
        self._g_forecast = reg.gauge(
            "m2kt_autoscale_forecast_tps",
            "Forecast admitted-token demand (tokens/s) at now + lead")
        self._g_lead = reg.gauge(
            "m2kt_autoscale_lead_time_s",
            "Forecast horizon = measured replica cold-join time")
        self._g_actual = reg.gauge(
            "m2kt_autoscale_actual_replicas",
            "Replica count the controller last observed (the "
            "ActuationStalled alert compares this to the target)")
        self._events = reg.counter(
            "m2kt_autoscale_events_total",
            "Scaling decisions applied, by direction",
            labels=("direction",), max_series=4)
        self._g_lead.set(self.config.lead_time_s)

    def capacity_tps(self) -> float:
        cap = self._capacity() if callable(self._capacity) else \
            float(self._capacity)
        return max(1e-6, cap)

    def desired(self, now: float | None = None) -> int:
        """Raw target: forecast demand at now+lead over usable capacity
        per replica, clamped to [min, max]. No hysteresis here."""
        cfg = self.config
        tps = self.forecaster.forecast(cfg.lead_time_s, now=now)
        self._g_forecast.set(tps)
        usable = self.capacity_tps() * cfg.target_util
        want = math.ceil(tps / usable) if tps > 0 else cfg.min_replicas
        return max(cfg.min_replicas, min(cfg.max_replicas, want))

    def decide(self, current: int, now: float | None = None) -> int:
        """The hysteresis step: returns the replica count to actuate.
        Up moves apply immediately; a down move needs the raw target to
        have stayed below ``current`` for ``down_delay_s`` continuously
        (one higher sample resets the timer), and then shrinks by at
        most one replica per decision so a forecast undershoot never
        cliffs the fleet."""
        now = self._clock() if now is None else float(now)
        target = self.desired(now=now)
        self._g_actual.set(float(current))
        if target > current:
            self._below_since = None
            self._g_target.set(float(target))
            self._events.labels(direction="up").inc()
            return target
        if target < current:
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= self.config.down_delay_s:
                self._below_since = now  # re-arm for the next step down
                new = current - 1
                self._g_target.set(float(new))
                self._events.labels(direction="down").inc()
                return new
        else:
            self._below_since = None
        self._g_target.set(float(current))
        return current


# ---------------------------------------------------------------------------
# in-process actuation
# ---------------------------------------------------------------------------

class FleetActuator:
    """Grow/shrink an in-process fleet (``build_fleet`` Router) to the
    controller's target. Grow appends factory-built replicas (the
    factory returns a STARTED ``InProcessReplica``); shrink marks the
    tail replica down first — no new placements — then drains it
    through the drain path and closes it, so a scale-down by
    construction never drops a stream. ``lost_streams`` counts drains
    that timed out with work still in flight (their waiters got the
    retryable ``ReplicaDraining``, so even then the router resumes
    them — the counter is the bench gate's evidence, not a leak)."""

    def __init__(self, router, replica_factory,
                 drain_grace_s: float = 30.0) -> None:
        self.router = router
        self._factory = replica_factory
        self.drain_grace_s = float(drain_grace_s)
        self._seq = len(router.replicas)
        self.lost_streams = 0

    def replicas(self) -> int:
        return len(self.router.replicas)

    def scale_to(self, target: int) -> int:
        target = max(0, int(target))
        while len(self.router.replicas) < target:
            name = f"replica-{self._seq}"
            self._seq += 1
            replica = self._factory(name)
            self.router.replicas.append(replica)
            self.router._up[replica.name] = True
            self.router._replica_up.labels(replica=replica.name).set(1.0)
        while len(self.router.replicas) > target:
            replica = self.router.replicas[-1]
            self.router._mark_down(replica, reason="scale-down")
            clean = True
            try:
                clean = replica.drain(self.drain_grace_s)
            finally:
                replica.close()
                self.router.replicas.remove(replica)
                self.router._up.pop(replica.name, None)
            if not clean:
                self.lost_streams += 1
        return len(self.router.replicas)


# ---------------------------------------------------------------------------
# emitted controller Deployment main loop
# ---------------------------------------------------------------------------

def _split_labels(line: str, name: str) -> tuple[str, str] | None:
    """Split one exposition line of family ``name`` into
    ``(label_section, rest)``. Quote-aware: a ``}`` inside a quoted
    label value (tenants are untrusted header strings) does not end the
    label section. Returns None when the line is not this family or is
    malformed — the caller warns and moves on, never raises."""
    if line.startswith(name + "{"):
        i = len(name) + 1
        in_quotes = False
        escaped = False
        while i < len(line):
            c = line[i]
            if escaped:
                escaped = False
            elif c == "\\":
                escaped = True
            elif c == '"':
                in_quotes = not in_quotes
            elif c == "}" and not in_quotes:
                return line[len(name) + 1:i], line[i + 1:].strip()
            i += 1
        return None  # unterminated label section
    if line.startswith(name + " ") or line.startswith(name + "\t"):
        return "", line[len(name):].strip()
    return None


def parse_counter_total(text: str, name: str) -> float:
    """Sum every sample of ``name`` (all label sets) in a Prometheus
    text exposition page. Tolerant of anything that is not the metric,
    of labeled families (quote-aware — a ``}`` inside a tenant label
    value does not truncate the parse), and of exposition lines with
    trailing timestamps (``name value timestamp``: the VALUE is the
    first token after the labels, not the last token on the line).
    Malformed samples warn and are skipped — this runs inside the
    emitted controller loop and must fail open, never crash it."""
    total = 0.0
    bad = 0
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if not line.startswith(name):
            continue
        parts = _split_labels(line, name)
        if parts is None:
            if line.startswith(name + "{"):
                bad += 1  # this family, unterminated labels
            continue
        _, rest = parts
        fields = rest.split()
        try:
            total += float(fields[0])
        except (IndexError, ValueError):
            bad += 1
            continue
    if bad:
        log.warning("%d malformed exposition line(s) for %s skipped",
                    bad, name)
    return total


def parse_counter_by_label(text: str, name: str,
                           label: str) -> dict[str, float]:
    """Per-label-value sums of ``name`` — the per-tenant split of the
    same page :func:`parse_counter_total` aggregates. Samples missing
    the label fold into ``""``; malformed samples warn and are skipped
    (same fail-open contract)."""
    import re

    out: dict[str, float] = {}
    bad = 0
    pat = re.compile(label + r'="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or not line.startswith(name):
            continue
        parts = _split_labels(line, name)
        if parts is None:
            if line.startswith(name + "{"):
                bad += 1
            continue
        labels_raw, rest = parts
        fields = rest.split()
        try:
            value = float(fields[0])
        except (IndexError, ValueError):
            bad += 1
            continue
        m = pat.search(labels_raw)
        key = ""
        if m:
            key = (m.group(1).replace('\\"', '"')
                   .replace("\\n", "\n").replace("\\\\", "\\"))
        out[key] = out.get(key, 0.0) + value
    if bad:
        log.warning("%d malformed exposition line(s) for %s skipped",
                    bad, name)
    return out


def scrape_admitted_tokens(url: str, timeout_s: float = 5.0) -> float | None:
    """Net admitted-token counter from the router's /metrics page, or
    None on any failure (the loop skips the sample rather than feeding
    the forecaster a zero that reads as demand collapse)."""
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            text = resp.read().decode("utf-8", "replace")
        return (parse_counter_total(text, ADMITTED_COUNTER)
                - parse_counter_total(text, UNUSED_COUNTER))
    except Exception as err:  # noqa: BLE001 - scrape is best-effort
        log.warning("metrics scrape %s failed: %s", url, err)
        return None


def scrape_tenant_admitted_tokens(
        url: str, timeout_s: float = 5.0) -> dict[str, float] | None:
    """Per-tenant net admitted-token counters from the router's
    /metrics page (admitted minus the unused corrections), or None on
    any failure. Negative per-tenant nets clamp to 0 — a correction
    outpacing admissions is not negative demand."""
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            text = resp.read().decode("utf-8", "replace")
        admitted = parse_counter_by_label(text, ADMITTED_COUNTER, "tenant")
        unused = parse_counter_by_label(text, UNUSED_COUNTER, "tenant")
        return {tenant: max(0.0, value - unused.get(tenant, 0.0))
                for tenant, value in admitted.items()}
    except Exception as err:  # noqa: BLE001 - scrape is best-effort
        log.warning("tenant metrics scrape %s failed: %s", url, err)
        return None


class KubeScaleActuator:
    """PATCH the target Deployment's scale subresource through the
    in-cluster API (service-account token + CA bundle). Fail-open:
    any API error logs and returns False — the controller keeps
    forecasting and exporting gauges, which is its observe-only mode
    anyway. Only engaged when ``M2KT_AUTOSCALE_ACTUATE=1``."""

    TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"  # noqa: S105
    CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
    NS = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"

    def __init__(self, deployment: str, namespace: str | None = None):
        self.deployment = deployment
        self.namespace = namespace or self._default_ns()

    def _default_ns(self) -> str:
        try:
            with open(self.NS, encoding="utf-8") as fh:
                return fh.read().strip() or "default"
        except OSError:
            return "default"

    def scale_to(self, target: int) -> bool:
        import ssl
        import urllib.request
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            log.warning("no KUBERNETES_SERVICE_HOST; cannot actuate")
            return False
        try:
            with open(self.TOKEN, encoding="utf-8") as fh:
                token = fh.read().strip()
            ctx = ssl.create_default_context(cafile=self.CA)
            url = (f"https://{host}:{port}/apis/apps/v1/namespaces/"
                   f"{self.namespace}/deployments/{self.deployment}/scale")
            body = json.dumps(
                {"spec": {"replicas": int(target)}}).encode("utf-8")
            req = urllib.request.Request(
                url, data=body, method="PATCH",
                headers={
                    "Authorization": f"Bearer {token}",
                    "Content-Type": "application/merge-patch+json",
                })
            with urllib.request.urlopen(req, timeout=10, context=ctx):
                return True
        except Exception as err:  # noqa: BLE001 - observe-only fallback
            log.warning("scale patch %s/%s -> %d failed: %s",
                        self.namespace, self.deployment, target, err)
            return False


def run_controller(loops: int | None = None,
                   registry: Registry | None = None,
                   clock=time.monotonic, sleep=time.sleep) -> int:
    """Main loop of the emitted autoscaler Deployment: scrape the
    router counters, forecast, decide, export gauges, optionally patch
    the decode Deployment's scale. Runs forever in the pod (``loops``
    bounds it for tests). Returns the last target.

    The forecast is per-tenant (closing the ROADMAP item-2 leftover):
    each tenant's net admitted-token counter feeds its own
    Holt-Winters forecaster, the controller scales on the sum, and the
    split exports as ``m2kt_autoscale_tenant_forecast_tps{tenant}``.
    When the page carries no tenant labels the whole rate lands on the
    ``default`` tenant, which degrades to exactly the old aggregate
    behavior."""
    from move2kube_tpu_torch.obs.slo import DEFAULT_TENANT, max_tenants

    cfg = AutoscaleConfig.from_env()
    url = os.environ.get(METRICS_URL_ENV, "").strip()
    target_deploy = os.environ.get(TARGET_ENV, "").strip()
    if not url:
        raise SystemExit(f"{METRICS_URL_ENV} is required for the "
                         "autoscaler role")
    reg = registry or default_registry()
    window_s = max(30.0, 2 * cfg.interval_s)
    forecaster = TenantDemandForecaster(clock=clock,
                                        max_tenants=max_tenants())
    demand = TenantCounterDemand(forecaster, clock=clock,
                                 window_s=window_s)
    scaler = PredictiveAutoscaler(
        forecaster, lambda: replica_capacity_tps(default=100.0),
        config=cfg, clock=clock, registry=reg)
    g_tenant_forecast = reg.gauge(
        "m2kt_autoscale_tenant_forecast_tps",
        "Forecast admitted-token demand per tenant at now + lead",
        labels=("tenant",), max_series=max_tenants() + 1)
    actuator = None
    if target_deploy and os.environ.get(ACTUATE_ENV, "").strip() == "1":
        actuator = KubeScaleActuator(target_deploy)
    current = cfg.min_replicas
    n = 0
    while loops is None or n < loops:
        n += 1
        per_tenant = scrape_tenant_admitted_tokens(url)
        if per_tenant is None:
            # labeled scrape failed outright; the aggregate fallback
            # keeps the controller fed through a degraded page
            value = scrape_admitted_tokens(url)
            per_tenant = None if value is None else {DEFAULT_TENANT: value}
        if per_tenant is not None:
            if not per_tenant:
                per_tenant = {DEFAULT_TENANT: 0.0}
            demand.tick(per_tenant)
            for tenant, tps in forecaster.forecast_by_tenant(
                    cfg.lead_time_s).items():
                g_tenant_forecast.labels(tenant=tenant).set(tps)
            new = scaler.decide(current)
            if new != current and actuator is not None:
                if actuator.scale_to(new):
                    current = new
            elif actuator is None:
                current = new  # shadow mode tracks its own decision
        if loops is None or n < loops:
            sleep(cfg.interval_s)
    return current
