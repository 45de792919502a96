"""Dependency-free, thread-safe metrics registry with Prometheus
text-format v0.0.4 exposition: the port's own copy of
``move2kube_tpu/obs/metrics.py`` (same names, same exposition text).

The serving engine registers its families here, and ``/metrics`` renders
:meth:`Registry.render`. Counter, Gauge and Histogram take labels; a
family with ``max_series`` sends every label tuple past its cap into one
``OVERFLOW_LABEL`` series and counts the redirect in ``DROPPED_SERIES``.
Histogram quantiles interpolate inside fixed buckets (Prometheus
``histogram_quantile``), so a server's memory does not grow with its
step count.

Concurrency model: one re-entrant lock per registry guards the family
table and every sample update. Collect hooks run *outside* the lock so
they may themselves set gauges.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

# prometheus_client's default buckets: latency-shaped, seconds
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

# where capped families send series beyond ``max_series``: one shared
# overflow bucket instead of unbounded growth from untrusted label
# values (tenant ids arrive on request headers)
OVERFLOW_LABEL = "other"

# every labels() call a capped family redirected into the overflow seat,
# by family — the cap used to fire silently, which made "tenant 'other'
# is hot" indistinguishable from "the cap is eating real tenants"
DROPPED_SERIES = "m2kt_obs_series_dropped_total"


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Prometheus sample formatting: integral floats render bare."""
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    """One metric family: a name + help + label names + children keyed by
    label-value tuples. A label-less family has a single child keyed ().

    ``max_series > 0`` caps distinct children: the first ``max_series``
    label tuples get their own series, everything after collapses into a
    shared ``("other", ...)`` child — first-come seats approximate the
    top-K heavy hitters, and an adversary spraying unique tenant headers
    grows the exposition by at most one series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 lock: threading.RLock, max_series: int = 0) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = int(max_series)
        self._lock = lock
        self._children: dict[tuple[str, ...], object] = {}
        # registry-installed callback fired on every overflow redirect
        self._on_overflow = None

    def labels(self, *values, **kwvalues):
        if kwvalues:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "keyword, not both")
            try:
                values = tuple(str(kwvalues[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}") from e
            if len(kwvalues) != len(self.labelnames):
                raise ValueError(f"unexpected labels for {self.name}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label values, "
                f"got {len(values)}")
        overflowed = False
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if (self.max_series > 0 and self.labelnames
                        and len(self._children) >= self.max_series):
                    overflowed = True
                    values = (OVERFLOW_LABEL,) * len(self.labelnames)
                    child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
        if overflowed and self._on_overflow is not None:
            try:
                self._on_overflow(self.name)
            except Exception:  # noqa: BLE001 - accounting must not break updates
                pass
        return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels "
                             f"{self.labelnames}; use .labels(...)")
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def _label_str(self, values: tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def _render(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for values in sorted(self._children):
            self._render_child(out, values, self._children[values])

    def _render_child(self, out, values, child) -> None:
        raise NotImplementedError

    def total(self) -> float:
        """Sum of every child's scalar value across label sets — the
        PromQL ``sum(family)`` a single process can answer directly.
        Counters and gauges only; families whose children carry no
        scalar ``value`` (histograms) contribute 0."""
        with self._lock:
            return float(sum(getattr(c, "value", 0.0)
                             for c in self._children.values()))

    def samples(self) -> list[tuple[tuple[str, ...], float]]:
        """Consistent ``[(label_values, value)]`` snapshot of every
        scalar child — the usage ledger reads per-tenant counters this
        way instead of reparsing its own exposition page. Histogram
        children (no scalar ``value``) are skipped; use
        :meth:`Histogram.snapshots` for those."""
        with self._lock:
            return [(values, float(child.value))
                    for values, child in self._children.items()
                    if hasattr(child, "value")]


class _Value:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _render_child(self, out, values, child) -> None:
        out.append(f"{self.name}{self._label_str(values)} "
                   f"{_fmt(child.value)}")


class _CounterChild:
    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only go up")
        with self._lock:
            self.value += amount


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().inc(-amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def _render_child(self, out, values, child) -> None:
        out.append(f"{self.name}{self._label_str(values)} "
                   f"{_fmt(child.value)}")


class _GaugeChild:
    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=DEFAULT_BUCKETS, max_series: int = 0) -> None:
        super().__init__(name, help, labelnames, lock,
                         max_series=max_series)
        edges = sorted(float(b) for b in buckets)
        if not edges:
            raise ValueError("histogram needs at least one bucket")
        if edges[-1] != math.inf:
            edges.append(math.inf)
        self.buckets = tuple(edges)

    def _make_child(self):
        return HistogramChild(self.buckets, self._lock)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)

    def snapshot(self) -> "HistogramSnapshot":
        return self._default_child().snapshot()

    def snapshots(self) -> dict[tuple[str, ...], "HistogramSnapshot"]:
        """Per-label-set :class:`HistogramSnapshot` copies — how the
        usage ledger freezes the per-tenant latency distributions."""
        with self._lock:
            children = dict(self._children)
        return {values: child.snapshot()
                for values, child in children.items()}

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def _render_child(self, out, values, child) -> None:
        cumulative = 0
        for edge, n in zip(self.buckets, child.bucket_counts):
            cumulative += n
            le = self._label_str(values, f'le="{_fmt(edge)}"')
            out.append(f"{self.name}_bucket{le} {cumulative}")
        out.append(f"{self.name}_sum{self._label_str(values)} "
                   f"{_fmt(child.sum)}")
        out.append(f"{self.name}_count{self._label_str(values)} "
                   f"{child.count}")


class HistogramChild:
    """Fixed-bucket accumulator: O(buckets) memory no matter how many
    observations — the bounded replacement for grow-forever latency
    lists in long-running servers."""

    def __init__(self, buckets: tuple[float, ...],
                 lock: threading.RLock) -> None:
        self.buckets = buckets
        self._lock = lock
        self.bucket_counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    self.bucket_counts[i] += 1
                    break

    def quantile(self, q: float) -> float:
        """Estimate a quantile by linear interpolation inside the bucket
        the rank falls in (Prometheus ``histogram_quantile`` semantics).
        Ranks landing in the +Inf bucket clamp to the last finite edge."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            rank = q * total
            cumulative = 0
            for i, edge in enumerate(self.buckets):
                prev_cum = cumulative
                cumulative += self.bucket_counts[i]
                if cumulative >= rank and self.bucket_counts[i]:
                    if edge == math.inf:
                        finite = [e for e in self.buckets if e != math.inf]
                        return finite[-1] if finite else 0.0
                    lo = self.buckets[i - 1] if i else 0.0
                    frac = (rank - prev_cum) / self.bucket_counts[i]
                    return lo + (edge - lo) * min(1.0, max(0.0, frac))
            return 0.0

    def snapshot(self) -> "HistogramSnapshot":
        """Consistent point-in-time copy of this child's state, safe to
        read (or sample from) without holding the registry lock."""
        with self._lock:
            return HistogramSnapshot(self.buckets,
                                     tuple(self.bucket_counts),
                                     self.sum, self.count)


class HistogramSnapshot:
    """Immutable copy of one histogram's buckets — the engine's own
    latency distributions handed to consumers that must not race the
    serving hot path: the fleet simulator samples per-phase service
    times from these via :meth:`sample`, and offline analysis reads
    :meth:`quantile` without touching the live registry."""

    __slots__ = ("buckets", "bucket_counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...],
                 bucket_counts: tuple[int, ...],
                 sum_: float, count: int) -> None:
        self.buckets = tuple(buckets)
        self.bucket_counts = tuple(bucket_counts)
        self.sum = float(sum_)
        self.count = int(count)

    def quantile(self, q: float) -> float:
        """Same interpolation as the live child (Prometheus
        ``histogram_quantile`` semantics), off the frozen counts."""
        total = self.count
        if total == 0:
            return 0.0
        rank = q * total
        cumulative = 0
        for i, edge in enumerate(self.buckets):
            prev_cum = cumulative
            cumulative += self.bucket_counts[i]
            if cumulative >= rank and self.bucket_counts[i]:
                if edge == math.inf:
                    finite = [e for e in self.buckets if e != math.inf]
                    return finite[-1] if finite else 0.0
                lo = self.buckets[i - 1] if i else 0.0
                frac = (rank - prev_cum) / self.bucket_counts[i]
                return lo + (edge - lo) * min(1.0, max(0.0, frac))
        return 0.0

    def sample(self, u: float) -> float:
        """Inverse-CDF draw: map a uniform ``u`` in [0, 1) to a value
        distributed like the recorded observations (linear within each
        bucket; the +Inf bucket clamps to the last finite edge). Feed it
        seeded uniforms and a million draws replay the engine's own
        latency shape deterministically."""
        return self.quantile(min(1.0, max(0.0, float(u))))


class TimedWindow:
    """Bounded, thread-safe deque of ``(t, item)`` samples with horizon
    pruning and trailing-window queries — the one owner of the sliding-
    window math the SLO tracker, the demand forecaster's rate sampler,
    and anything else windowing a timeline kept re-implementing.

    ``clock`` is injectable (synthetic timelines in tests and the fleet
    simulator); the horizon and the item cap both prune on append, so a
    flood can never grow the window without bound."""

    def __init__(self, horizon_s: float, max_items: int = 65536,
                 clock=time.monotonic) -> None:
        self.horizon_s = float(horizon_s)
        self.max_items = max(1, int(max_items))
        self._clock = clock
        self._lock = threading.Lock()
        self._items: deque[tuple[float, object]] = deque()

    def append(self, item, t: float | None = None) -> float:
        """Record one sample (at ``t``, default now); returns the
        timestamp used."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            self._items.append((now, item))
            floor = now - self.horizon_s
            while self._items and (len(self._items) > self.max_items
                                   or self._items[0][0] < floor):
                self._items.popleft()
        return now

    def window(self, window_s: float,
               now: float | None = None) -> list:
        """Items whose timestamp falls inside the trailing window."""
        if now is None:
            now = self._clock()
        floor = now - float(window_s)
        with self._lock:
            return [item for t, item in self._items if t >= floor]

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class WindowRate:
    """Windowed per-second rate over a monotone counter reading.

    ``read`` is any zero-arg callable returning the counter's current
    value (e.g. ``family.total``); :meth:`sample` records one
    ``(t, value)`` observation and :meth:`rate` differences the newest
    sample against the last sample at or before the window floor, so
    the rate covers the whole window instead of whatever sub-span two
    in-window samples happen to straddle. This is the counter
    ``rate(window_s)`` the forecaster consumes — callers stop keeping
    their own (t, value) deques."""

    def __init__(self, read, clock=time.monotonic,
                 horizon_s: float = 7200.0,
                 max_samples: int = 4096) -> None:
        self._read = read
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, float]] = deque()
        self.horizon_s = float(horizon_s)
        self.max_samples = max(2, int(max_samples))

    def sample(self, t: float | None = None,
               value: float | None = None) -> tuple[float, float]:
        """Record one observation (``value`` defaults to ``read()``,
        ``t`` to now); returns the ``(t, value)`` pair recorded."""
        now = self._clock() if t is None else float(t)
        val = float(self._read() if value is None else value)
        with self._lock:
            self._samples.append((now, val))
            floor = now - self.horizon_s
            # keep ONE sample below the floor as the differencing base
            while (len(self._samples) > self.max_samples
                   or (len(self._samples) > 2
                       and self._samples[1][0] <= floor)):
                self._samples.popleft()
        return now, val

    def rate(self, window_s: float, now: float | None = None) -> float:
        """Per-second rate over the trailing window; 0.0 with fewer
        than two samples. A counter that stepped backwards (a correction
        outpacing admissions) clamps to 0 — a demand rate is never
        negative."""
        if now is None:
            now = self._clock()
        floor = now - float(window_s)
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            t1, v1 = self._samples[-1]
            base = self._samples[0]
            for t, v in self._samples:
                if t > floor:
                    break
                base = (t, v)
            t0, v0 = base
        if t1 <= t0:
            return 0.0
        return max(0.0, (v1 - v0) / (t1 - t0))


class Registry:
    """Named metric families + get-or-create registration + exposition.

    get-or-create (vs prometheus_client's register-once-or-raise) because
    instruments live inside reusable classes (ServingEngine,
    StepTelemetry) that tests construct many times per process."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}
        self._collect_hooks: list = []

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"{name} already registered as {fam.kind}")
                return fam
            fam = cls(name, help, tuple(labels), self._lock, **kw)
            if name != DROPPED_SERIES:
                fam._on_overflow = self._note_series_drop
            self._families[name] = fam
            return fam

    def _note_series_drop(self, family: str) -> None:
        """Count one cardinality-cap trip: a ``labels()`` lookup this
        registry redirected into a family's overflow seat. The drop
        counter itself is uncapped (family names are code-controlled)
        and exempt from the callback, so the accounting can't recurse."""
        self.counter(
            DROPPED_SERIES,
            "Label lookups redirected into the 'other' overflow series "
            "by a family's max_series cap", labels=("family",),
        ).labels(family=family).inc()

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = (),
                max_series: int = 0) -> Counter:
        return self._get_or_create(Counter, name, help, labels,
                                   max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = (),
              max_series: int = 0) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels,
                                   max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets=DEFAULT_BUCKETS,
                  max_series: int = 0) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets, max_series=max_series)

    def add_collect_hook(self, fn) -> None:
        """Run ``fn()`` at every exposition, before rendering — the pull
        model's answer to metrics whose source of truth lives elsewhere
        (goodput tracker, trace recorder): refresh on scrape instead of
        polling on a timer."""
        with self._lock:
            if fn not in self._collect_hooks:
                self._collect_hooks.append(fn)

    def render(self) -> str:
        """Prometheus text-format v0.0.4 exposition of every family."""
        for hook in list(self._collect_hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 - a bad hook must not 500 /metrics
                pass
        out: list[str] = []
        with self._lock:
            for name in sorted(self._families):
                self._families[name]._render(out)
        return "\n".join(out) + "\n" if out else ""


_default = Registry()


def default_registry() -> Registry:
    return _default
