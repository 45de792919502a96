"""Per-tenant SLO ledger: the port's own copy of
``move2kube_tpu/obs/slo.py`` on the port's registry
(:mod:`move2kube_tpu_torch.obs.metrics`).

An ``SLOSpec`` names the contract a serving replica is held to (TTFT p95
target, per-token latency target, availability), from ``M2KT_SLO_*``.
The ``SLOTracker`` turns the engine's per-request outcomes into that
contract's ledger:

- a request is *good* when it completed AND met the latency targets;
  the good fraction over a sliding window is the attainment;
- burn rate = (1 - attainment) / error_budget: burn 1.0 spends the
  budget exactly over the SLO period;
- alerts use *paired* windows (long AND short over threshold), the
  canonical 1h/5m (14.4x) and 6h/30m (6x) pairs, scaled by
  ``M2KT_SLO_WINDOW_SCALE``.

Everything exports as ``m2kt_slo_*`` gauges refreshed on scrape (a
collect hook), including per-tenant p95 TTFT and attainment under the
bounded ``tenant`` label (``M2KT_OBS_MAX_TENANTS`` seats + ``other``
overflow).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from move2kube_tpu_torch.obs.metrics import OVERFLOW_LABEL, Registry, TimedWindow

TTFT_P95_ENV = "M2KT_SLO_TTFT_P95_S"
TOKEN_P95_ENV = "M2KT_SLO_TOKEN_P95_S"
AVAILABILITY_ENV = "M2KT_SLO_AVAILABILITY"
WINDOW_SCALE_ENV = "M2KT_SLO_WINDOW_SCALE"
MAX_TENANTS_ENV = "M2KT_OBS_MAX_TENANTS"

DEFAULT_TTFT_P95_S = 0.5
DEFAULT_TOKEN_P95_S = 0.05
DEFAULT_AVAILABILITY = 0.99
DEFAULT_MAX_TENANTS = 8
DEFAULT_TENANT = "default"

# the header tenant identity rides on, router -> replica -> engine
TENANT_HEADER = "X-M2KT-Tenant"

# canonical SRE-workbook pairs: (long_window_s, short_window_s) and the
# burn-rate multiple that must hold over BOTH for the alert to fire
FAST_BURN = 14.4
SLOW_BURN = 6.0
FAST_WINDOWS = (3600.0, 300.0)
SLOW_WINDOWS = (21600.0, 1800.0)

# hard cap on retained request outcomes regardless of window length — a
# flooded server must not hold the flood in memory to account for it
DEFAULT_MAX_EVENTS = 65536


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        val = float(raw) if raw.strip() else default
    except (TypeError, ValueError):
        return default
    return val if val > 0 else default


def max_tenants() -> int:
    """How many tenants get their own label seat before overflow
    collapses into ``other`` (``M2KT_OBS_MAX_TENANTS``, default 8)."""
    raw = os.environ.get(MAX_TENANTS_ENV, "")
    try:
        val = int(raw) if raw.strip() else DEFAULT_MAX_TENANTS
    except (TypeError, ValueError):
        return DEFAULT_MAX_TENANTS
    return max(1, val)


def clean_tenant(raw: str | None) -> str:
    """Normalize an untrusted tenant header value into a label-safe id:
    printable, bounded length, never empty. The cardinality cap bounds
    the series count; this bounds each value."""
    t = (raw or "").strip()
    if not t:
        return DEFAULT_TENANT
    t = "".join(c if c.isprintable() else "_" for c in t)
    return t[:64]


@dataclass(frozen=True)
class SLOSpec:
    """The declarative serving contract. Zero/negative targets disable
    that dimension (a request cannot miss a target that is off)."""

    ttft_p95_s: float = DEFAULT_TTFT_P95_S
    token_p95_s: float = DEFAULT_TOKEN_P95_S
    availability: float = DEFAULT_AVAILABILITY
    # scales every burn window: 1.0 = the canonical 1h/5m + 6h/30m
    # pairs; a drill sets it tiny so floods register in seconds
    window_scale: float = 1.0

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.availability)

    @property
    def fast_windows(self) -> tuple[float, float]:
        return (FAST_WINDOWS[0] * self.window_scale,
                FAST_WINDOWS[1] * self.window_scale)

    @property
    def slow_windows(self) -> tuple[float, float]:
        return (SLOW_WINDOWS[0] * self.window_scale,
                SLOW_WINDOWS[1] * self.window_scale)

    @classmethod
    def from_env(cls) -> "SLOSpec":
        avail = _env_float(AVAILABILITY_ENV, DEFAULT_AVAILABILITY)
        if not 0 < avail < 1:
            avail = DEFAULT_AVAILABILITY
        return cls(
            ttft_p95_s=_env_float(TTFT_P95_ENV, DEFAULT_TTFT_P95_S),
            token_p95_s=_env_float(TOKEN_P95_ENV, DEFAULT_TOKEN_P95_S),
            availability=avail,
            window_scale=_env_float(WINDOW_SCALE_ENV, 1.0),
        )


def _p95(values: list[float]) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]


class SLOTracker:
    """Sliding-window request-outcome ledger + burn-rate arithmetic.

    ``clock`` is injectable (tests feed synthetic timelines; production
    uses ``time.monotonic``). Thread-safe: the engine records from its
    step loop while the telemetry thread exports on scrape.
    """

    def __init__(self, spec: SLOSpec | None = None,
                 registry: Registry | None = None,
                 clock=time.monotonic,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 tenant_cap: int | None = None) -> None:
        self.spec = spec or SLOSpec.from_env()
        self._clock = clock
        self._horizon = max(self.spec.fast_windows[0],
                            self.spec.slow_windows[0])
        # (t, tenant, good, ttft_s or None) events; the shared
        # TimedWindow (obs/metrics.py) owns horizon/cap pruning and the
        # trailing-window queries — same math the demand forecaster uses
        self._events = TimedWindow(self._horizon,
                                   max_items=max(1, int(max_events)),
                                   clock=clock)
        self.tenant_cap = tenant_cap if tenant_cap is not None else (
            max_tenants())
        self._registry = registry
        if registry is not None:
            self._init_metrics(registry)
            registry.add_collect_hook(self.export)

    def _init_metrics(self, reg: Registry) -> None:
        self._g_attain = reg.gauge(
            "m2kt_slo_attainment",
            "good-request fraction over each burn window",
            labels=("window",))
        self._g_burn = reg.gauge(
            "m2kt_slo_burn_rate",
            "error-budget burn rate over each burn window "
            "(1.0 spends the budget exactly over the SLO period)",
            labels=("window",))
        self._g_fast = reg.gauge(
            "m2kt_slo_fast_burn_firing",
            "1 when burn rate exceeds the fast threshold over BOTH "
            "paired fast windows")
        self._g_slow = reg.gauge(
            "m2kt_slo_slow_burn_firing",
            "1 when burn rate exceeds the slow threshold over BOTH "
            "paired slow windows")
        self._g_budget = reg.gauge(
            "m2kt_slo_error_budget",
            "1 - availability target: the bad fraction the SLO tolerates")
        self._g_ttft_target = reg.gauge(
            "m2kt_slo_ttft_p95_target_seconds",
            "the TTFT p95 objective requests are judged against")
        cap = self.tenant_cap
        self._g_tenant_ttft = reg.gauge(
            "m2kt_slo_tenant_ttft_p95_seconds",
            "observed TTFT p95 per tenant over the long fast window",
            labels=("tenant",), max_series=cap)
        self._g_tenant_attain = reg.gauge(
            "m2kt_slo_tenant_attainment",
            "good-request fraction per tenant over the long fast window",
            labels=("tenant",), max_series=cap)

    # -- recording ---------------------------------------------------------

    def judge(self, ok: bool, ttft_s: float | None = None,
              token_s: float | None = None) -> bool:
        """One request against the contract: completed AND within every
        enabled latency target."""
        if not ok:
            return False
        if (self.spec.ttft_p95_s > 0 and ttft_s is not None
                and ttft_s > self.spec.ttft_p95_s):
            return False
        if (self.spec.token_p95_s > 0 and token_s is not None
                and token_s > self.spec.token_p95_s):
            return False
        return True

    def record(self, tenant: str = DEFAULT_TENANT, ok: bool = True,
               ttft_s: float | None = None,
               token_s: float | None = None) -> bool:
        """Record one request outcome; returns its good/bad verdict."""
        good = self.judge(ok, ttft_s, token_s)
        now = self._clock()
        self._events.append((now, clean_tenant(tenant), good, ttft_s),
                            t=now)
        return good

    # -- windows -----------------------------------------------------------

    def _window(self, window_s: float,
                tenant: str | None = None) -> list[tuple]:
        events = self._events.window(window_s)
        if tenant is None:
            return events
        return [e for e in events if e[1] == tenant]

    def attainment(self, window_s: float | None = None,
                   tenant: str | None = None) -> float:
        """Good fraction over the window; 1.0 when empty (no traffic
        spends no budget)."""
        if window_s is None:
            window_s = self.spec.fast_windows[0]
        events = self._window(window_s, tenant)
        if not events:
            return 1.0
        return sum(1 for e in events if e[2]) / len(events)

    def burn_rate(self, window_s: float | None = None,
                  tenant: str | None = None) -> float:
        return ((1.0 - self.attainment(window_s, tenant))
                / self.spec.error_budget)

    def fast_burn_firing(self) -> bool:
        long_w, short_w = self.spec.fast_windows
        return (self.burn_rate(long_w) >= FAST_BURN
                and self.burn_rate(short_w) >= FAST_BURN)

    def slow_burn_firing(self) -> bool:
        long_w, short_w = self.spec.slow_windows
        return (self.burn_rate(long_w) >= SLOW_BURN
                and self.burn_rate(short_w) >= SLOW_BURN)

    def tenants(self) -> list[str]:
        """Distinct tenants inside the long fast window, first-seen
        order, capped to the label budget (+ ``other`` when truncated)."""
        seen: dict[str, None] = {}
        for e in self._window(self.spec.fast_windows[0]):
            seen.setdefault(e[1])
        names = list(seen)
        if len(names) > self.tenant_cap:
            names = names[:self.tenant_cap] + [OVERFLOW_LABEL]
        return names

    def tenant_ttft_p95(self, tenant: str) -> float:
        events = self._window(self.spec.fast_windows[0])
        if tenant == OVERFLOW_LABEL:
            # overflow aggregates every tenant beyond the first cap seats
            kept: dict[str, None] = {}
            for e in events:
                kept.setdefault(e[1])
            inside = set(list(kept)[:self.tenant_cap])
            vals = [e[3] for e in events
                    if e[1] not in inside and e[3] is not None]
        else:
            vals = [e[3] for e in events
                    if e[1] == tenant and e[3] is not None]
        return _p95([float(v) for v in vals])

    # -- exposition --------------------------------------------------------

    def export(self) -> None:
        """Refresh every ``m2kt_slo_*`` gauge (collect hook: runs on
        scrape, outside the registry lock)."""
        if self._registry is None:
            return
        spec = self.spec
        windows = {
            "fast_long": spec.fast_windows[0],
            "fast_short": spec.fast_windows[1],
            "slow_long": spec.slow_windows[0],
            "slow_short": spec.slow_windows[1],
        }
        for label, w in windows.items():
            att = self.attainment(w)
            self._g_attain.labels(label).set(att)
            self._g_burn.labels(label).set(
                (1.0 - att) / spec.error_budget)
        self._g_fast.set(1.0 if self.fast_burn_firing() else 0.0)
        self._g_slow.set(1.0 if self.slow_burn_firing() else 0.0)
        self._g_budget.set(spec.error_budget)
        self._g_ttft_target.set(spec.ttft_p95_s)
        for tenant in self.tenants():
            if tenant == OVERFLOW_LABEL:
                self._g_tenant_ttft.labels(tenant).set(
                    self.tenant_ttft_p95(tenant))
                continue
            events = self._window(spec.fast_windows[0], tenant)
            vals = [e[3] for e in events if e[3] is not None]
            self._g_tenant_ttft.labels(tenant).set(
                _p95([float(v) for v in vals]))
            good = sum(1 for e in events if e[2])
            self._g_tenant_attain.labels(tenant).set(
                good / len(events) if events else 1.0)
