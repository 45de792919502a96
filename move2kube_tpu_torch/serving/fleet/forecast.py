"""Arrival-rate forecaster for the predictive autoscaler.

The port's own copy of ``move2kube_tpu/serving/fleet/forecast.py``, on
the port's obs modules, with the same names, keys and metric families.

The reactive HPAs (fleet_wiring) scale on queue depth — a signal that
only moves AFTER capacity is already short, which at diurnal traffic
means the fleet is perpetually one cold-join behind the curve. This
module predicts the demand instead, from the router's own per-tenant
admitted-token counters (``m2kt_router_admitted_tokens_total`` minus
the completion corrections):

- **Holt level + trend**: exponentially-weighted level with a
  per-second trend term, normalized for irregular sample cadence, so a
  ramp extrapolates instead of lagging by one smoothing constant;
- **additive diurnal seasonal component**: the day is discretized into
  bins and each bin keeps an EWMA of the deviation from the level, so
  tomorrow's 9am spike is priced into today's 9am-minus-lead forecast
  the second time it happens;
- **horizon = cold-join time**: the forecaster is always asked for the
  demand at ``now + lead``, where the lead is the measured time a new
  replica needs to join and warm (the kernel-cache prewarm is exactly
  the lead this loop gets to spend).

The clock is injectable and nothing here imports the engine: the fleet
simulator drives the same forecaster through millions of synthetic
seconds, and the emitted controller Deployment feeds it from a scraped
``/metrics`` text page. Stdlib-only (vendored into emitted images).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

from move2kube_tpu_torch.obs.metrics import WindowRate

DAY_S = 86400.0


@dataclass(frozen=True)
class ForecastConfig:
    """Smoothing constants for the Holt-Winters-style estimator.

    The defaults assume samples every ~15-60s: level follows minutes,
    trend follows tens of minutes, the seasonal field follows days.
    ``season_bins`` trades seasonal resolution against warm-up time —
    48 bins = one seat per half hour of the day."""

    alpha: float = 0.3      # level gain per observation
    beta: float = 0.1       # trend gain (per-second slope units)
    gamma: float = 0.3      # seasonal-deviation gain per bin visit
    season_s: float = DAY_S
    season_bins: int = 48
    # trend is clamped so one noisy burst cannot extrapolate the fleet
    # to max replicas: |trend| <= level * max_trend_frac per second
    max_trend_frac: float = 0.01
    # time constant of the slow reference mean the seasonal field and
    # the trend are measured against (None = one season period). Short
    # values make the trend chase fast ramps — the bench live smoke
    # uses that; production wants the default so the diurnal swing
    # stays OUT of the mean and lands in the seasonal bins.
    mean_tau_s: float | None = None


class DemandForecaster:
    """EWMA level+trend with an additive diurnal seasonal component.

    Feed it demand-rate observations (tokens/s) via :meth:`observe`, or
    raw monotone counter readings via :meth:`observe_counter`; ask for
    the rate expected ``horizon_s`` from now via :meth:`forecast`.

    ``epoch`` anchors the seasonal bins (defaults to the first
    observation's timestamp) so synthetic timelines and the simulator
    get reproducible bin placement.
    """

    def __init__(self, config: ForecastConfig | None = None,
                 clock=time.monotonic, epoch: float | None = None) -> None:
        self.config = config or ForecastConfig()
        self._clock = clock
        self._epoch = epoch
        self.level = 0.0
        self.trend = 0.0  # tokens/s per second
        self.mean = 0.0   # slow reference mean (seasonal baseline)
        self._seasonal = [0.0] * max(1, int(self.config.season_bins))
        self._seen_bins = [False] * len(self._seasonal)
        self._last_t: float | None = None
        self.observations = 0

    # -- seasonal bins -----------------------------------------------------

    def _bin(self, t: float) -> int:
        period = max(1e-9, float(self.config.season_s))
        phase = ((t - (self._epoch or 0.0)) % period) / period
        return min(len(self._seasonal) - 1,
                   int(phase * len(self._seasonal)))

    def seasonal(self, t: float) -> float:
        """The learned deviation-from-level for ``t``'s bin of the day
        (0 until that bin has been visited)."""
        b = self._bin(t)
        return self._seasonal[b] if self._seen_bins[b] else 0.0

    # -- updates -----------------------------------------------------------

    def observe(self, tps: float, t: float | None = None) -> None:
        """One demand-rate observation (tokens/s) at time ``t``
        (default: now). Robust to irregular cadence: the trend is a
        per-second slope, projected over the actual gap."""
        now = self._clock() if t is None else float(t)
        tps = max(0.0, float(tps))
        if self._epoch is None:
            self._epoch = now
        cfg = self.config
        b = self._bin(now)
        season = self._seasonal[b] if self._seen_bins[b] else 0.0
        if self._last_t is None:
            self.mean = tps
            self.level = tps - season
        else:
            dt = max(1e-9, now - self._last_t)
            # slow reference mean, cadence-free (gain derives from the
            # actual gap, so 0.2s and 30min tickers see the same tau)
            tau = cfg.mean_tau_s if cfg.mean_tau_s else cfg.season_s
            gain = 1.0 - math.exp(-dt / max(1e-9, tau))
            prev_mean = self.mean
            self.mean = gain * tps + (1.0 - gain) * self.mean
            # trend = smoothed slope of the SLOW mean: secular growth
            # only. Tracking the level's slope here double-counts the
            # diurnal swing the seasonal field already prices in
            # (measured 2.2x WORSE than persistence on a clean diurnal
            # signal; this form measures ~0.4x).
            slope = (self.mean - prev_mean) / dt
            self.trend = cfg.beta * slope + (1.0 - cfg.beta) * self.trend
            predicted = self.level + self.trend * dt
            self.level = (cfg.alpha * (tps - season)
                          + (1.0 - cfg.alpha) * predicted)
            cap = abs(self.level) * cfg.max_trend_frac
            self.trend = max(-cap, min(cap, self.trend))
        # the seasonal field learns the deviation from the slow mean —
        # NOT from the fast level, which chases the curve and eats the
        # seasonality before the bins can learn it. A bin's first visit
        # snaps to the full residual so day one already prices the
        # curve; later visits blend at gamma.
        if not self._seen_bins[b]:
            self._seasonal[b] = tps - self.mean
        else:
            self._seasonal[b] = (cfg.gamma * (tps - self.mean)
                                 + (1.0 - cfg.gamma) * season)
        self._seen_bins[b] = True
        self._last_t = now
        self.observations += 1

    def forecast(self, horizon_s: float = 0.0,
                 now: float | None = None) -> float:
        """Expected demand rate (tokens/s) ``horizon_s`` from now:
        level, plus the trend projected over the horizon, plus the
        seasonal deviation of the bin the horizon LANDS in — which is
        the whole point: the forecast prices in the part of the day the
        new capacity will serve, not the part it was decided in."""
        if self.observations == 0:
            return 0.0
        if now is None:
            now = self._last_t if self._last_t is not None \
                else self._clock()
        target = now + max(0.0, float(horizon_s))
        return max(0.0, self.level + self.trend * max(0.0, horizon_s)
                   + self.seasonal(target))


class TenantDemandForecaster:
    """Per-tenant :class:`DemandForecaster` bank behind the aggregate
    forecaster's API — the ROADMAP item-2 leftover: the emitted
    controller used to forecast one aggregate rate, so a burst in one
    tenant was smeared across the seasonal memory of all of them.

    ``observe(tenant, tps)`` routes to that tenant's forecaster
    (first-come seats up to ``max_tenants``; later tenants share one
    overflow forecaster, the same bounded-cardinality convention as the
    metric labels). ``forecast(horizon_s)`` sums the per-tenant
    forecasts, so a :class:`PredictiveAutoscaler` holding this object
    needs no changes; :meth:`forecast_by_tenant` exposes the split for
    gauges and chargeback-aware scaling. All tenants share one seasonal
    epoch so their diurnal bins align."""

    OVERFLOW = "other"

    def __init__(self, config: ForecastConfig | None = None,
                 clock=time.monotonic, epoch: float | None = None,
                 max_tenants: int = 8) -> None:
        self.config = config or ForecastConfig()
        self._clock = clock
        self._epoch = epoch
        self.max_tenants = max(1, int(max_tenants))
        self._forecasters: dict[str, DemandForecaster] = {}

    def _get(self, tenant: str) -> DemandForecaster:
        f = self._forecasters.get(tenant)
        if f is None:
            if (len(self._forecasters) >= self.max_tenants
                    and tenant != self.OVERFLOW):
                return self._get(self.OVERFLOW)
            f = self._forecasters[tenant] = DemandForecaster(
                self.config, clock=self._clock, epoch=self._epoch)
        return f

    def tenants(self) -> list[str]:
        return list(self._forecasters)

    def observe(self, tenant: str, tps: float,
                t: float | None = None) -> None:
        now = self._clock() if t is None else float(t)
        if self._epoch is None:
            # one shared epoch: every tenant's seasonal bins align
            self._epoch = now
        self._get(str(tenant)).observe(tps, t=now)

    def forecast_by_tenant(self, horizon_s: float = 0.0,
                           now: float | None = None) -> dict[str, float]:
        return {tenant: f.forecast(horizon_s, now=now)
                for tenant, f in self._forecasters.items()}

    def forecast(self, horizon_s: float = 0.0,
                 now: float | None = None) -> float:
        """Aggregate demand = sum of per-tenant forecasts — the shape
        :class:`PredictiveAutoscaler` consumes unchanged."""
        return sum(self.forecast_by_tenant(horizon_s, now=now).values())

    @property
    def observations(self) -> int:
        return sum(f.observations for f in self._forecasters.values())


class CounterDemand:
    """Demand-rate source over a monotone token counter: wraps the
    shared :class:`WindowRate` sampler (obs/metrics.py) and feeds a
    forecaster, so neither the in-process autoscaler (reading
    ``router.admitted_tokens``) nor the emitted controller (reading a
    scraped counter value) re-implements the window math."""

    def __init__(self, read, forecaster: DemandForecaster,
                 clock=time.monotonic, window_s: float = 60.0) -> None:
        self.forecaster = forecaster
        self.window_s = float(window_s)
        self._rate = WindowRate(read, clock=clock,
                                horizon_s=max(600.0, 10 * window_s))
        self._clock = clock

    def tick(self, t: float | None = None,
             value: float | None = None) -> float:
        """Sample the counter, fold the windowed rate into the
        forecaster, return the observed tokens/s."""
        now, _val = self._rate.sample(t=t, value=value)
        tps = self._rate.rate(self.window_s, now=now)
        self.forecaster.observe(tps, t=now)
        return tps


class TenantCounterDemand:
    """Per-tenant :class:`CounterDemand`: one :class:`WindowRate` per
    tenant over scraped counter values, feeding a
    :class:`TenantDemandForecaster`. The emitted controller ticks this
    with the per-tenant net-admitted-token dict each scrape."""

    def __init__(self, forecaster: TenantDemandForecaster,
                 clock=time.monotonic, window_s: float = 60.0) -> None:
        self.forecaster = forecaster
        self.window_s = float(window_s)
        self._clock = clock
        self._rates: dict[str, WindowRate] = {}

    def _seat(self, tenant: str) -> str:
        """The rate-window key ``tenant`` lands on: its own seat while
        seats remain, the shared overflow seat after (cap + 1 windows
        total, the same convention as the metric labels)."""
        if tenant in self._rates:
            return tenant
        if len(self._rates) >= self.forecaster.max_tenants:
            tenant = TenantDemandForecaster.OVERFLOW
            if tenant in self._rates:
                return tenant
        self._rates[tenant] = WindowRate(
            lambda: 0.0, clock=self._clock,
            horizon_s=max(600.0, 10 * self.window_s))
        return tenant

    def tick(self, totals: dict[str, float],
             t: float | None = None) -> dict[str, float]:
        """Fold one scrape's per-tenant counter totals in; returns the
        observed per-tenant tokens/s. Tenants beyond the seat cap fold
        into the shared overflow rate BEFORE differencing, so their
        combined counter still differences correctly."""
        now = self._clock() if t is None else float(t)
        folded: dict[str, float] = {}
        for tenant, value in totals.items():
            key = self._seat(str(tenant))
            folded[key] = folded.get(key, 0.0) + float(value)
        out: dict[str, float] = {}
        for key, value in folded.items():
            rate = self._rates[key]
            rate.sample(t=now, value=value)
            tps = rate.rate(self.window_s, now=now)
            self.forecaster.observe(key, tps, t=now)
            out[key] = tps
        return out
