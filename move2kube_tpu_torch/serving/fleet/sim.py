"""Discrete-event fleet simulator: autoscaler policies at planet scale.

The port's own copy of ``move2kube_tpu/serving/fleet/sim.py``, on
the port's obs modules, with the same names, keys and metric families.

The CPU probe can physically serve a few requests per second; real
diurnal traffic is millions of users. This module closes that gap the
only honest way a CI gate can: **no model execution at all**. Requests
are events; service times are drawn from per-phase latency
distributions — either the engine's own Prometheus histograms
(:class:`~move2kube_tpu_torch.obs.metrics.HistogramSnapshot` inverse-CDF,
so the simulator replays the measured latency shape) or synthetic
lognormals; the fleet is an aggregate multi-server queue with
simulated cold-join delay and replica-hours billing. A 24h trace with
over a million distinct simulated users runs in seconds on a laptop
CPU, which is what lets the bench ``autoscale`` phase gate a policy
comparison (predictive forecaster vs reactive HPA) on every push.

Model, deliberately simple and stated here so its biases are known:

- **arrivals**: per-tick Poisson counts from a diurnal sinusoid plus
  optional burst windows, users drawn from a large id pool (zipfian
  tenant attribution rides along for per-tenant attainment);
- **service**: ``prefill + new_tokens * per_token``; TTFT = queue wait
  + prefill; no shedding — under-capacity shows up as TTFT misses,
  which is exactly the signal the policies are judged on;
- **capacity**: replicas * slots, fungible (no affinity); scale-up
  becomes serving capacity ``cold_join_s`` after the decision but is
  **billed from the decision** (real clouds charge for the boot);
  scale-down stops admissions on the shrinking share immediately and
  releases a replica only when enough streams have finished — the
  aggregate analogue of the engine's drain, so a scaling decision can
  never lose a stream (``lost_streams`` is asserted 0, not measured);
- **policies**: :class:`ReactiveHPAPolicy` mimics a queue-occupancy
  HPA (15s sync, 300s scale-down stabilization window); the
  predictive side runs the REAL production controller
  (:class:`~move2kube_tpu_torch.serving.fleet.autoscaler.PredictiveAutoscaler`
  + :class:`~move2kube_tpu_torch.serving.fleet.forecast.DemandForecaster`)
  against simulated time — the simulator is a harness, not a fork.

Determinism: one ``numpy`` seed fixes the trace and every sample;
equal seeds give bit-equal results, which the tests pin.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from heapq import heappop, heappush

import numpy as np

from move2kube_tpu_torch.obs.metrics import Registry
from move2kube_tpu_torch.serving.fleet.autoscaler import (
    AutoscaleConfig, PredictiveAutoscaler)
from move2kube_tpu_torch.serving.fleet.forecast import (
    DemandForecaster, ForecastConfig)

DAY_S = 86400.0
_INF = float("inf")


# ---------------------------------------------------------------------------
# latency model
# ---------------------------------------------------------------------------

def _snapshot_sampler(snap):
    """Vectorized inverse-CDF over a HistogramSnapshot: maps uniforms
    to values with the recorded bucket shape (linear within buckets,
    +Inf clamped to the last finite edge)."""
    counts = np.asarray(snap.bucket_counts, dtype=np.float64)
    edges = np.asarray(snap.buckets, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        return lambda n, rng: np.zeros(n)
    cdf = np.cumsum(counts) / total
    finite = edges[np.isfinite(edges)]
    hi = np.where(np.isfinite(edges), edges,
                  finite[-1] if finite.size else 0.0)
    lo = np.concatenate(([0.0], hi[:-1]))
    prev_cdf = np.concatenate(([0.0], cdf[:-1]))
    width = np.maximum(1e-12, cdf - prev_cdf)

    def sample(n, rng):
        u = rng.random(n)
        idx = np.searchsorted(cdf, u, side="left")
        idx = np.minimum(idx, len(cdf) - 1)
        frac = (u - prev_cdf[idx]) / width[idx]
        return lo[idx] + (hi[idx] - lo[idx]) * np.clip(frac, 0.0, 1.0)

    return sample


def _lognormal_sampler(mean: float, sigma: float):
    # parameterized so the SAMPLE mean equals ``mean``
    mu = math.log(max(1e-9, mean)) - 0.5 * sigma * sigma

    def sample(n, rng):
        return rng.lognormal(mu, sigma, n)

    return sample


class LatencyModel:
    """Per-phase service-time samplers: ``prefill_s`` per request and
    ``per_token_s`` per decoded token."""

    def __init__(self, prefill_sampler, per_token_sampler) -> None:
        self._prefill = prefill_sampler
        self._per_token = per_token_sampler

    @classmethod
    def from_histograms(cls, prefill_snap, per_token_snap):
        """Build from the engine's own histogram snapshots — the
        simulator then replays the measured latency distributions."""
        return cls(_snapshot_sampler(prefill_snap),
                   _snapshot_sampler(per_token_snap))

    @classmethod
    def synthetic(cls, prefill_mean_s: float = 0.15,
                  per_token_mean_s: float = 0.04,
                  sigma: float = 0.35):
        return cls(_lognormal_sampler(prefill_mean_s, sigma),
                   _lognormal_sampler(per_token_mean_s, sigma))

    def sample(self, n: int, rng):
        return self._prefill(n, rng), self._per_token(n, rng)


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceConfig:
    """A diurnal/bursty arrival trace over a large user population.

    Defaults are sized for the bench gate: ~1.1M requests over 24h
    drawn from a 20M-user pool, which yields > 1M DISTINCT simulated
    users while keeping two full policy runs comfortably inside the
    60s CI budget."""

    duration_s: float = DAY_S
    requests_total: int = 1_100_000
    user_pool: int = 20_000_000
    tick_s: float = 60.0
    # diurnal sinusoid: rate = base * (1 + amplitude*sin(phase)), with
    # the peak centered at ``peak_hour``
    diurnal_amplitude: float = 0.8
    peak_hour: float = 14.0
    # burst windows: (start_s, duration_s, rate_multiplier) — the
    # defaults model two recurring daily surges (a morning login rush
    # and an evening flash event), the traffic reactive HPAs lose to
    bursts: tuple = ((9.5 * 3600.0, 1800.0, 2.5),
                     (20.0 * 3600.0, 1800.0, 3.0))
    tenants: int = 8
    zipf_exponent: float = 1.2
    prompt_tokens_mean: float = 128.0
    decode_tokens_mean: float = 96.0
    seed: int = 0


@dataclass(frozen=True)
class FleetConfig:
    slots_per_replica: int = 8
    min_replicas: int = 2
    max_replicas: int = 32
    initial_replicas: int = 4
    cold_join_s: float = 120.0
    ttft_slo_s: float = 2.0


@dataclass
class SimResult:
    policy: str = ""
    requests: int = 0
    distinct_users: int = 0
    duration_s: float = 0.0
    attainment: float = 0.0          # fraction of requests inside SLO
    p95_ttft_s: float = 0.0
    replica_hours: float = 0.0
    mean_replicas: float = 0.0
    peak_replicas: int = 0
    scale_events: int = 0
    lost_streams: int = 0            # 0 by construction; asserted
    per_tenant_attainment: dict = field(default_factory=dict)
    wall_s: float = 0.0

    def to_dict(self) -> dict:
        out = dict(self.__dict__)
        out["per_tenant_attainment"] = dict(self.per_tenant_attainment)
        return out


class Trace:
    """Pre-generated arrival trace: times, per-request tokens/service
    samples, tenants — everything the event loop indexes, nothing it
    computes."""

    def __init__(self, cfg: TraceConfig, latency: LatencyModel,
                 rng=None) -> None:
        self.cfg = cfg
        rng = rng or np.random.default_rng(cfg.seed)
        n_ticks = int(math.ceil(cfg.duration_s / cfg.tick_s))
        tick_t = np.arange(n_ticks) * cfg.tick_s
        shape = self.rate_shape(tick_t)
        base = cfg.requests_total / max(1e-9, shape.sum() * cfg.tick_s)
        counts = rng.poisson(base * shape * cfg.tick_s)
        total = int(counts.sum())
        offsets = rng.random(total) * cfg.tick_s
        self.arrival_s = np.sort(
            np.repeat(tick_t, counts) + offsets)
        self.n = total
        users = rng.integers(0, cfg.user_pool, total)
        self.distinct_users = int(np.unique(users).size)
        # zipfian tenant attribution (rank-frequency over ``tenants``)
        ranks = np.arange(1, cfg.tenants + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_exponent
        probs /= probs.sum()
        self.tenant = rng.choice(cfg.tenants, size=total, p=probs)
        prompt = rng.poisson(cfg.prompt_tokens_mean, total)
        decode = np.maximum(1, rng.poisson(cfg.decode_tokens_mean, total))
        self.tokens = (prompt + decode).astype(np.float64)
        prefill_s, per_token_s = latency.sample(total, rng)
        self.prefill_s = prefill_s
        self.service_s = prefill_s + decode * per_token_s
        # per-tick admitted-token demand, the counter the forecaster
        # differences in production — vectorized here so the predictive
        # policy's observe() costs nothing in the hot loop
        bins = np.minimum((self.arrival_s / cfg.tick_s).astype(np.int64),
                          n_ticks - 1)
        self.tokens_per_tick = np.bincount(
            bins, weights=self.tokens, minlength=n_ticks)
        self.mean_slot_tps = float(
            self.tokens.mean() / max(1e-9, self.service_s.mean()))

    def rate_shape(self, t) -> np.ndarray:
        """Relative arrival rate at time(s) ``t`` (unnormalized)."""
        cfg = self.cfg
        phase = 2.0 * math.pi * (t / DAY_S - cfg.peak_hour / 24.0)
        shape = 1.0 + cfg.diurnal_amplitude * np.cos(phase)
        shape = np.maximum(0.05, shape)
        for start, dur, mult in cfg.bursts:
            shape = np.where((t >= start) & (t < start + dur),
                             shape * mult, shape)
        return shape


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

class ReactiveHPAPolicy:
    """Queue-occupancy HPA as Kubernetes runs it: desired =
    ceil(current * occupancy / target), 15s sync period, scale-down
    takes the max recommendation over a 300s stabilization window.
    Cold-joining replicas are invisible to the metric (not ready), so
    the formula overshoots on ramps — which is the documented behavior
    this phase quantifies, not a strawman."""

    name = "reactive_hpa"

    def __init__(self, fleet: FleetConfig, sync_s: float = 15.0,
                 target_occupancy: float = 0.7,
                 down_stabilization_s: float = 300.0) -> None:
        self.fleet = fleet
        self.interval_s = float(sync_s)
        self.target = float(target_occupancy)
        self.stab_s = float(down_stabilization_s)
        self._window: deque = deque()

    def decide(self, now: float, busy: int, active: int,
               provisioned: int, tps_observed: float) -> int:
        cap = max(1, active * self.fleet.slots_per_replica)
        occupancy = busy / cap
        desired = int(math.ceil(active * occupancy / self.target)) \
            if occupancy > 0 else self.fleet.min_replicas
        desired = max(self.fleet.min_replicas,
                      min(self.fleet.max_replicas, desired))
        self._window.append((now, desired))
        floor = now - self.stab_s
        while self._window and self._window[0][0] < floor:
            self._window.popleft()
        if desired > provisioned:
            return desired
        # scale-down: most conservative (max) recommendation in window
        rec = max(d for _, d in self._window)
        return min(provisioned, max(rec, self.fleet.min_replicas))


class PredictivePolicy:
    """The production predictive controller run against simulated time:
    a real DemandForecaster fed the per-tick admitted-token rate, and a
    real PredictiveAutoscaler making the replica decision. ``warmup``
    pre-trains the seasonal field on one synthetic prior day (the
    production controller has yesterday's counters; the simulator must
    grant the same memory or the comparison is rigged against it)."""

    name = "predictive"

    def __init__(self, trace: Trace, fleet: FleetConfig,
                 target_util: float = 0.7, down_delay_s: float = 180.0,
                 warmup: bool = True) -> None:
        self.interval_s = float(trace.cfg.tick_s)
        self.fleet = fleet
        replica_tps = trace.mean_slot_tps * fleet.slots_per_replica
        self._tokens_per_tick = trace.tokens_per_tick
        self._tick_s = trace.cfg.tick_s
        self.forecaster = DemandForecaster(
            ForecastConfig(), clock=lambda: 0.0, epoch=0.0)
        self.scaler = PredictiveAutoscaler(
            self.forecaster, replica_tps,
            config=AutoscaleConfig(
                interval_s=self.interval_s,
                min_replicas=fleet.min_replicas,
                max_replicas=fleet.max_replicas,
                target_util=target_util,
                lead_time_s=fleet.cold_join_s,
                down_delay_s=down_delay_s),
            clock=lambda: 0.0, registry=Registry())
        if warmup:
            # yesterday: the same diurnal expectation, observed at tick
            # cadence with t shifted one period back
            ticks = np.arange(len(self._tokens_per_tick)) * self._tick_s
            shape = trace.rate_shape(ticks)
            mean_tps = (self._tokens_per_tick.sum()
                        / max(1e-9, len(ticks) * self._tick_s))
            expected = shape / max(1e-9, shape.mean()) * mean_tps
            for i, tps in enumerate(expected):
                self.forecaster.observe(float(tps),
                                        t=ticks[i] - trace.cfg.duration_s)

    def decide(self, now: float, busy: int, active: int,
               provisioned: int, tps_observed: float) -> int:
        self.forecaster.observe(tps_observed, t=now)
        return self.scaler.decide(provisioned, now=now)


# ---------------------------------------------------------------------------
# event loop
# ---------------------------------------------------------------------------

def simulate(trace: Trace, fleet: FleetConfig, policy) -> SimResult:
    """Run one policy over one trace. Single pass over arrivals with a
    completion heap — O((N + ticks) log c) — so a million-request day
    takes seconds."""
    wall0 = time.perf_counter()
    cfg = trace.cfg
    spr = fleet.slots_per_replica
    arrival = trace.arrival_s.tolist()
    service = trace.service_s.tolist()
    prefill = trace.prefill_s.tolist()
    n = trace.n
    ttft = np.empty(n, dtype=np.float64)

    heap: list = []  # (finish_time, request_index) — index unused, kept
    queue: deque = deque()          # request indices waiting for a slot
    queued_at: deque = deque()
    busy = 0
    active = fleet.initial_replicas          # serving replicas
    pending_up: deque = deque()              # cold-join effective times
    pending_down = 0                         # replicas draining
    scale_events = 0
    # billing: integral of billed replicas (active + cold-joining) over
    # time, charged from the moment of the scale-up decision
    billed = active
    bill_t = 0.0
    replica_seconds = 0.0
    peak = billed
    tick_i = 0
    tick_s = policy.interval_s
    next_tick = tick_s
    tokens_per_tick = trace.tokens_per_tick
    trace_tick_s = cfg.tick_s

    def bill(now: float) -> None:
        nonlocal replica_seconds, bill_t
        replica_seconds += billed * (now - bill_t)
        bill_t = now

    def control(now: float) -> None:
        nonlocal billed, pending_down, scale_events, peak, tick_i
        provisioned = active + len(pending_up) - pending_down
        # the demand rate the production controller would read off the
        # admitted-tokens counter over the last trace tick
        ti = min(int(now / trace_tick_s), len(tokens_per_tick) - 1)
        tps = float(tokens_per_tick[ti]) / trace_tick_s
        target = policy.decide(now, busy, active, provisioned, tps)
        target = max(fleet.min_replicas,
                     min(fleet.max_replicas, target))
        if target > provisioned:
            bill(now)
            grow = target - provisioned
            # cancel drains first: un-draining a replica is free
            cancel = min(grow, pending_down)
            pending_down -= cancel
            grow -= cancel
            billed += grow
            peak = max(peak, billed)
            for _ in range(grow):
                pending_up.append(now + fleet.cold_join_s)
            scale_events += 1
        elif target < provisioned:
            pending_down += provisioned - target
            scale_events += 1

    def on_complete(tc: float) -> None:
        nonlocal busy, active, pending_down, billed
        if pending_down and active > 1 \
                and busy - 1 <= (active - 1) * spr:
            # a draining replica's last stream finished: release it
            busy -= 1
            bill(tc)
            active -= 1
            billed -= 1
            pending_down -= 1
        elif queue and busy - 1 < (active - pending_down) * spr:
            j = queue.popleft()
            ta = queued_at.popleft()
            ttft[j] = (tc - ta) + prefill[j]
            heappush(heap, tc + service[j])
        else:
            busy -= 1

    def on_join(tj: float) -> None:
        nonlocal active, busy
        active += 1
        pending_up.popleft()
        cap = (active - pending_down) * spr
        while queue and busy < cap:
            j = queue.popleft()
            ta = queued_at.popleft()
            ttft[j] = (tj - ta) + prefill[j]
            heappush(heap, tj + service[j])
            busy += 1

    for i in range(n):
        t = arrival[i]
        while True:
            tc = heap[0] if heap else _INF
            tj = pending_up[0] if pending_up else _INF
            te = min(next_tick, tj, tc)
            if te > t:
                break
            if tc == te:
                heappop(heap)
                on_complete(tc)
            elif tj == te:
                on_join(tj)
            else:
                control(next_tick)
                next_tick += tick_s
        if not queue and busy < (active - pending_down) * spr:
            busy += 1
            ttft[i] = prefill[i]
            heappush(heap, t + service[i])
        else:
            queue.append(i)
            queued_at.append(t)

    # epilogue: drain everything still queued or in flight (control
    # keeps ticking so late scale-downs are billed honestly)
    while heap or queue:
        tc = heap[0] if heap else _INF
        tj = pending_up[0] if pending_up else _INF
        te = min(next_tick, tj, tc)
        if tc == te:
            heappop(heap)
            on_complete(tc)
        elif tj == te:
            on_join(tj)
        else:
            control(next_tick)
            next_tick += tick_s
    bill(max(cfg.duration_s, bill_t))

    good = ttft <= fleet.ttft_slo_s
    per_tenant = {}
    # captured traces carry the real tenant names; synthetic ones rank
    names = getattr(trace, "tenant_names", None) \
        or [f"tenant-{tid}" for tid in range(cfg.tenants)]
    for tid in range(cfg.tenants):
        mask = trace.tenant == tid
        if mask.any():
            per_tenant[names[tid]] = float(good[mask].mean())
    return SimResult(
        policy=getattr(policy, "name", type(policy).__name__),
        requests=n,
        distinct_users=trace.distinct_users,
        duration_s=float(cfg.duration_s),
        attainment=float(good.mean()),
        p95_ttft_s=float(np.percentile(ttft, 95)),
        replica_hours=replica_seconds / 3600.0,
        mean_replicas=replica_seconds / max(1e-9, cfg.duration_s),
        peak_replicas=int(peak),
        scale_events=scale_events,
        lost_streams=0,
        per_tenant_attainment=per_tenant,
        wall_s=time.perf_counter() - wall0,
    )


def compare_policies(trace_cfg: TraceConfig | None = None,
                     fleet_cfg: FleetConfig | None = None,
                     latency: LatencyModel | None = None,
                     trace=None) -> dict:
    """The bench gate: one trace, both policies, verdict. Returns
    ``{"trace": ..., "reactive": ..., "predictive": ...,
    "predictive_wins": bool}`` where winning means better SLO
    attainment AND fewer replica-hours on the SAME trace.

    ``trace`` accepts a prebuilt trace — in particular a
    :class:`~move2kube_tpu_torch.serving.fleet.capture.CapturedTrace`
    replaying recorded production traffic — in place of the synthetic
    diurnal generator; any duck-typed trace exposing the
    :class:`Trace` surface works."""
    fleet_cfg = fleet_cfg or FleetConfig()
    wall0 = time.perf_counter()
    if trace is None:
        trace_cfg = trace_cfg or TraceConfig()
        latency = latency or LatencyModel.synthetic()
        trace = Trace(trace_cfg, latency)
    else:
        trace_cfg = trace.cfg
    reactive = simulate(trace, fleet_cfg,
                        ReactiveHPAPolicy(fleet_cfg))
    predictive = simulate(trace, fleet_cfg,
                          PredictivePolicy(trace, fleet_cfg))
    wins = (predictive.attainment >= reactive.attainment
            and predictive.replica_hours < reactive.replica_hours)
    return {
        "trace": {
            "requests": trace.n,
            "distinct_users": trace.distinct_users,
            "duration_s": trace_cfg.duration_s,
            "seed": trace_cfg.seed,
        },
        "reactive": reactive.to_dict(),
        "predictive": predictive.to_dict(),
        "predictive_wins": bool(wins),
        "wall_s": time.perf_counter() - wall0,
    }
