"""Bridges: fold goodput reports and trace totals into an obs registry,
so one scrape carries step metrics, goodput and span totals; the
straggler detector; and the anomaly watchdog. The port's own copy of
``move2kube_tpu/obs/bridge.py``.

Both mirrors are idempotent gauge writes, so they compose with
:meth:`Registry.add_collect_hook`: the registry refreshes them on every
scrape instead of the workload polling on a timer. The goodput tracker
and the trace recorder are duck-typed (``report()``, ``to_dict()``); the
reference's default recorder, the translator's offline
``move2kube_tpu.utils.trace``, is not the port's to import, so the trace
mirror is a no-op without a recorder, as the reference's is in an image
that lacks that module.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from move2kube_tpu_torch.obs.metrics import Registry, default_registry


def mirror_trace(registry: Registry | None = None, recorder=None) -> None:
    """Mirror a trace recorder's span totals + counters (``to_dict()``:
    ``{"spans": {name: seconds}, "counters": {name: value}}``) into gauges
    (``m2kt_trace_span_seconds_total{span=...}``). No-op without a
    recorder."""
    reg = registry if registry is not None else default_registry()
    if recorder is None:
        return
    snap = recorder.to_dict()
    spans = reg.gauge(
        "m2kt_trace_span_seconds_total",
        "Cumulative wall seconds per pipeline span", labels=("span",))
    for name, seconds in snap.get("spans", {}).items():
        spans.labels(span=name).set(seconds)
    counters = reg.gauge(
        "m2kt_trace_counter", "utils.trace counters", labels=("name",))
    for name, value in snap.get("counters", {}).items():
        counters.labels(name=name).set(value)


def mirror_goodput(report: dict, registry: Registry | None = None) -> None:
    """Mirror a :func:`resilience.goodput` report into gauges: fraction,
    per-category seconds, and step watermarks."""
    reg = registry if registry is not None else default_registry()
    frac = report.get("goodput_fraction")
    if frac is not None:
        reg.gauge("m2kt_goodput_fraction",
                  "Fraction of wall-clock spent on productive steps"
                  ).set(float(frac))
    secs = reg.gauge("m2kt_goodput_seconds",
                     "Wall seconds per goodput category",
                     labels=("category",))
    for cat, val in report.get("seconds", {}).items():
        secs.labels(category=cat).set(float(val))
    for key, name in (("steps_done", "m2kt_goodput_steps_done"),
                      ("last_saved_step", "m2kt_goodput_last_saved_step")):
        if key in report:
            reg.gauge(name, f"Goodput watermark: {key}"
                      ).set(float(report[key]))


class StragglerDetector:
    """MegaScale-style slow-host identification from per-host step-time
    reports.

    Each host (or each simulated slice in one process) reports its
    wall time for every step; the detector keeps a bounded window per
    host and scores each host as ``median(host window) / median(fleet
    medians)`` — 1.0 means in line with the fleet, 1.5 means this host's
    steps take 50% longer than the typical host. Synchronous data-
    parallel training runs at the speed of the slowest participant, so a
    single straggling host taxes every step of every other host; the
    score makes the guilty one visible *before* anyone stares at 256
    per-host dashboards.

    Scores are exported as ``m2kt_straggler_score{host=...}`` gauges and
    crossing ``threshold`` increments
    ``m2kt_straggler_events_total{host=...}`` once per excursion (hyst:
    re-arms only after the score drops back under) — alertable without
    firing once per step while a host stays slow.
    """

    def __init__(self, registry: Registry | None = None,
                 threshold: float = 1.5, window: int = 32):
        reg = registry if registry is not None else default_registry()
        self.threshold = float(threshold)
        self.window = max(2, int(window))
        self._lock = threading.Lock()
        self._times: dict[str, deque[float]] = {}
        self._over: set[str] = set()
        self.events = 0
        self._score_gauge = reg.gauge(
            "m2kt_straggler_score",
            "Per-host median step time / fleet median (1.0 = in line)",
            labels=("host",))
        self._event_counter = reg.counter(
            "m2kt_straggler_events_total",
            "Straggler threshold crossings", labels=("host",))

    @staticmethod
    def _median(values) -> float:
        vals = sorted(values)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0

    def report(self, host: str, step: int, seconds: float) -> None:
        """Fold one (host, step time) observation in and refresh that
        host's score + event state."""
        with self._lock:
            times = self._times.get(host)
            if times is None:
                times = self._times[host] = deque(maxlen=self.window)
            times.append(max(0.0, float(seconds)))
            scores = self._scores_locked()
        score = scores.get(host)
        if score is None:
            return
        self._score_gauge.labels(host=host).set(round(score, 6))
        with self._lock:
            if score >= self.threshold and host not in self._over:
                self._over.add(host)
                self.events += 1
                fire = True
            else:
                if score < self.threshold:
                    self._over.discard(host)
                fire = False
        if fire:
            self._event_counter.labels(host=host).inc()

    def _scores_locked(self) -> dict[str, float]:
        medians = {h: self._median(t)
                   for h, t in self._times.items() if t}
        if not medians:
            return {}
        fleet = self._median(medians.values())
        if fleet <= 0:
            return {h: 1.0 for h in medians}
        return {h: m / fleet for h, m in medians.items()}

    def scores(self) -> dict[str, float]:
        """Current per-host scores (host median / fleet median)."""
        with self._lock:
            return self._scores_locked()


DIAG_ENV = "M2KT_DIAG"
DIAG_DIR_ENV = "M2KT_DIAG_DIR"
DIAG_MIN_INTERVAL_ENV = "M2KT_DIAG_MIN_INTERVAL_S"
DIAG_PROFILE_SECONDS_ENV = "M2KT_DIAG_PROFILE_S"
DIAG_MAX_CAPTURES_ENV = "M2KT_DIAG_MAX_CAPTURES"

DEFAULT_DIAG_MIN_INTERVAL_S = 600.0
DEFAULT_DIAG_PROFILE_S = 1.0
DEFAULT_DIAG_MAX_CAPTURES = 8


def diag_enabled() -> bool:
    return os.environ.get(DIAG_ENV, "1").lower() not in ("0", "false", "off")


def diag_dir() -> str:
    d = os.environ.get(DIAG_DIR_ENV, "")
    if d:
        return d
    return os.path.join(os.environ.get("M2KT_METRICS_DIR", "") or ".",
                        "m2kt-diag")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        val = float(raw) if raw.strip() else default
    except (TypeError, ValueError):
        return default
    return val if val >= 0 else default


class DiagWatchdog:
    """Anomaly-triggered auto-profiling: arm on trouble, capture once.

    The expensive diagnostics (a profiler trace, the span ring, the
    usage-ledger window) are exactly the data an engineer asks for
    *after* an incident — and by then the interesting window has rolled
    out of every ring. The watchdog watches three cheap signals and
    freezes a one-shot bundle the moment one fires:

    - **SLO fast-burn**: the tracker's paired-window burn-rate alarm
      (``slo.fast_burn_firing()``), checked on every :meth:`check`.
    - **Step-time regression**: p95 of the last ``short_window`` step
      times exceeds ``factor`` × the rolling-median baseline of the
      preceding window (fed via :meth:`observe_step`).
    - **Non-finite steps**: edge-triggered via :meth:`note_nonfinite`
      from the numerics guard.

    Level-triggered reasons use StragglerDetector-style hysteresis —
    fire once per excursion, re-arm only after the condition clears —
    and every capture passes a rate limiter
    (``M2KT_DIAG_MIN_INTERVAL_S``, default 600s) plus a lifetime cap
    (``M2KT_DIAG_MAX_CAPTURES``) so a flapping SLO cannot fill the disk
    with profiles. Captures are counted in
    ``m2kt_diag_captures_total{reason=...}`` (suppressions in
    ``m2kt_diag_suppressed_total{reason=...}``).

    Bundles land under ``M2KT_DIAG_DIR`` as ``diag-<reason>-<seq>/``
    with ``traces.json`` (span-ring drain), ``usage.json`` (trailing
    ledger window), a ``profile/`` torch.profiler trace, and
    ``manifest.json`` —
    written *last*, so a manifest's presence means the bundle is
    complete. The heavy work runs on a daemon thread: arming must cost
    the serve loop microseconds, not a profiler pause.
    """

    REASONS = ("slo_fast_burn", "step_regression", "nonfinite")

    def __init__(self, registry: Registry | None = None,
                 slo=None, tracer=None, ledger=None,
                 out_dir: str | None = None,
                 min_interval_s: float | None = None,
                 profile_seconds: float | None = None,
                 max_captures: int | None = None,
                 factor: float = 2.0, short_window: int = 16,
                 baseline_window: int = 128, min_baseline: int = 32,
                 ledger_window_s: float = 300.0,
                 clock=time.monotonic) -> None:
        reg = registry if registry is not None else default_registry()
        self.slo = slo
        self.tracer = tracer
        self.ledger = ledger
        self.out_dir = out_dir or diag_dir()
        self.min_interval_s = (min_interval_s if min_interval_s is not None
                               else _env_float(DIAG_MIN_INTERVAL_ENV,
                                               DEFAULT_DIAG_MIN_INTERVAL_S))
        self.profile_seconds = (profile_seconds
                                if profile_seconds is not None
                                else _env_float(DIAG_PROFILE_SECONDS_ENV,
                                                DEFAULT_DIAG_PROFILE_S))
        self.max_captures = (max_captures if max_captures is not None
                             else int(_env_float(DIAG_MAX_CAPTURES_ENV,
                                                 DEFAULT_DIAG_MAX_CAPTURES)))
        self.factor = float(factor)
        self.short_window = max(2, int(short_window))
        self.min_baseline = max(2, int(min_baseline))
        self.ledger_window_s = float(ledger_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._steps: deque[float] = deque(
            maxlen=self.short_window + max(self.short_window,
                                           int(baseline_window)))
        self._over: set[str] = set()
        self._last_capture_t: float | None = None
        self._seq = 0
        self._threads: list[threading.Thread] = []
        self.captures: list[str] = []
        self._c_captures = reg.counter(
            "m2kt_diag_captures_total",
            "Diagnostic bundles captured by the anomaly watchdog",
            labels=("reason",))
        self._c_suppressed = reg.counter(
            "m2kt_diag_suppressed_total",
            "Watchdog triggers suppressed by the capture rate limit",
            labels=("reason",))

    # -- signal feeds ------------------------------------------------------

    def observe_step(self, seconds: float) -> str | None:
        """Fold one step wall time in and run the trigger check."""
        with self._lock:
            self._steps.append(max(0.0, float(seconds)))
        return self.check()

    def note_nonfinite(self) -> str | None:
        """Edge trigger from the numerics guard (non-finite loss/grad)."""
        return self._request("nonfinite")

    # -- trigger evaluation ------------------------------------------------

    def _step_regressed(self) -> bool:
        with self._lock:
            steps = list(self._steps)
        short = steps[-self.short_window:]
        baseline = steps[:-self.short_window]
        if len(short) < self.short_window or len(baseline) < self.min_baseline:
            return False
        base = StragglerDetector._median(baseline)
        if base <= 0:
            return False
        p95 = sorted(short)[min(len(short) - 1,
                                int(0.95 * (len(short) - 1)))]
        return p95 >= self.factor * base

    def check(self) -> str | None:
        """Evaluate the level-triggered reasons; returns the bundle dir
        when this call captured one. Cheap — safe to call per step or
        per scrape."""
        fired = None
        for reason, live in (("slo_fast_burn", self._slo_firing),
                             ("step_regression", self._step_regressed)):
            try:
                now_firing = bool(live())
            except Exception:  # noqa: BLE001 - watchdog must not throw
                continue
            with self._lock:
                if now_firing and reason not in self._over:
                    self._over.add(reason)
                    edge = True
                else:
                    if not now_firing:
                        self._over.discard(reason)
                    edge = False
            if edge:
                fired = self._request(reason) or fired
        return fired

    def _slo_firing(self) -> bool:
        return self.slo is not None and self.slo.fast_burn_firing()

    # -- capture -----------------------------------------------------------

    def _request(self, reason: str) -> str | None:
        now = self._clock()
        with self._lock:
            if self._seq >= self.max_captures or (
                    self._last_capture_t is not None
                    and now - self._last_capture_t < self.min_interval_s):
                suppressed = True
            else:
                suppressed = False
                self._last_capture_t = now
                self._seq += 1
                seq = self._seq
        if suppressed:
            self._c_suppressed.labels(reason=reason).inc()
            return None
        bundle = os.path.join(self.out_dir, f"diag-{reason}-{seq:03d}")
        self._c_captures.labels(reason=reason).inc()
        self.captures.append(bundle)
        t = threading.Thread(target=self._capture, args=(reason, bundle),
                             name="m2kt-diag-capture", daemon=True)
        self._threads.append(t)
        t.start()
        return bundle

    def _capture(self, reason: str, bundle: str) -> None:
        manifest = {
            "schema": "m2kt-diag/v1",
            "reason": reason,
            "captured_unix": time.time(),
            "parts": [],
        }
        try:
            os.makedirs(bundle, exist_ok=True)
        except OSError:
            return
        if self.tracer is not None:
            try:
                doc = self.tracer.ring_doc()
                with open(os.path.join(bundle, "traces.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(doc, f)
                manifest["parts"].append("traces.json")
            except Exception as e:  # noqa: BLE001 - best-effort bundle
                manifest["errors"] = manifest.get("errors", []) + [str(e)]
        if self.ledger is not None:
            try:
                doc = self.ledger.doc(window_s=self.ledger_window_s)
                with open(os.path.join(bundle, "usage.json"), "w",
                          encoding="utf-8") as f:
                    json.dump(doc, f)
                manifest["parts"].append("usage.json")
            except Exception as e:  # noqa: BLE001
                manifest["errors"] = manifest.get("errors", []) + [str(e)]
        if self.profile_seconds > 0:
            try:
                self._profile(os.path.join(bundle, "profile"))
                manifest["parts"].append("profile")
            except Exception as e:  # noqa: BLE001 - best-effort bundle
                manifest["errors"] = manifest.get("errors", []) + [str(e)]
        # manifest last: its presence marks the bundle complete
        try:
            tmp = os.path.join(bundle, ".manifest.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f, sort_keys=True, indent=1)
            os.replace(tmp, os.path.join(bundle, "manifest.json"))
        except OSError:
            pass

    def _profile(self, profile_dir: str) -> None:
        from move2kube_tpu_torch.obs.server import profile_to

        os.makedirs(profile_dir, exist_ok=True)
        profile_to(profile_dir, self.profile_seconds)

    def wait(self, timeout_s: float = 10.0) -> None:
        """Join outstanding capture threads (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout_s
        for t in list(self._threads):
            t.join(max(0.0, deadline - time.monotonic()))


def install_trace_hook(registry: Registry | None = None,
                       recorder=None) -> None:
    """Refresh the trace mirror of ``recorder`` on every scrape."""
    reg = registry if registry is not None else default_registry()
    reg.add_collect_hook(lambda: mirror_trace(reg, recorder))


def install_goodput_hook(tracker, registry: Registry | None = None) -> None:
    """Refresh the goodput mirror from a live tracker on every scrape."""
    reg = registry if registry is not None else default_registry()
    reg.add_collect_hook(lambda: mirror_goodput(tracker.report(), reg))
