"""Usage ledger: a bounded time-series ring of per-pod usage snapshots,
the port's own copy of ``move2kube_tpu/obs/ledger.py`` (same schema,
sources and file format).

Every fleet role keeps a small ring of periodic snapshots (per-tenant
admitted/unused tokens and request counts, TTFT / token-latency / length
histogram snapshots, slot occupancy, preempt/throttle counters,
``weights_version``), serves it at ``GET /usage``, and flushes it to
``m2kt-usage.jsonl`` on exit by the same ``threading._register_atexit``
route as the span ring, so a pod that dies between scrapes still leaves
its usage trail on disk for the aggregator.

Data sources are duck-typed zero-arg callables (``add_source``):
:func:`engine_source` / :func:`router_source` build the standard adapters
over the port's ``ServingEngine`` and ``Router`` with tolerant
``getattr`` reads; a source raising or a field missing degrades that
snapshot, never the workload.

Determinism: ``clock`` is injectable and :meth:`UsageLedger.snapshot`
takes an explicit ``t``, so tests drive a synthetic timeline and get
identical rings. Stdlib-only.
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from collections import deque

from move2kube_tpu_torch.obs import tracing
from move2kube_tpu_torch.obs.metrics import HistogramSnapshot, Registry

USAGE_ENV = "M2KT_USAGE"
USAGE_INTERVAL_ENV = "M2KT_USAGE_INTERVAL_S"
USAGE_RING_ENV = "M2KT_USAGE_RING"
USAGE_PATH_ENV = "M2KT_USAGE_PATH"

SCHEMA = "m2kt-usage/v1"

DEFAULT_INTERVAL_S = 10.0
# 360 snapshots at the 10s default = one hour of history per pod,
# ~O(100KB) — bounded no matter how long the pod lives
DEFAULT_RING = 360


def enabled() -> bool:
    """Ledger defaults ON (``M2KT_USAGE``): a periodic dict merge is
    cheap, and an off-by-default ledger bills no one."""
    return os.environ.get(USAGE_ENV, "1").lower() not in ("0", "false", "off")


def usage_interval() -> float:
    raw = os.environ.get(USAGE_INTERVAL_ENV, "")
    try:
        val = float(raw) if raw.strip() else DEFAULT_INTERVAL_S
    except (TypeError, ValueError):
        return DEFAULT_INTERVAL_S
    return val if val > 0 else DEFAULT_INTERVAL_S


def usage_ring() -> int:
    raw = os.environ.get(USAGE_RING_ENV, "")
    try:
        val = int(raw) if raw.strip() else DEFAULT_RING
    except (TypeError, ValueError):
        return DEFAULT_RING
    return val if val > 0 else DEFAULT_RING


def usage_path() -> str:
    """Where the exit flush lands — next to the flight recorder's
    artifacts, derived from the same env so the aggregator and the
    dying pod agree without a handshake."""
    p = os.environ.get(USAGE_PATH_ENV, "")
    if p:
        return p
    return os.path.join(os.environ.get("M2KT_METRICS_DIR", "") or ".",
                        "m2kt-usage.jsonl")


# ---------------------------------------------------------------------------
# histogram (de)serialization — +Inf has no JSON literal
# ---------------------------------------------------------------------------


def hist_doc(snap: HistogramSnapshot) -> dict:
    """One histogram snapshot as a JSON-safe dict (the +Inf edge is
    serialized as null)."""
    return {
        "buckets": [None if b == math.inf else float(b)
                    for b in snap.buckets],
        "counts": [int(c) for c in snap.bucket_counts],
        "sum": float(snap.sum),
        "count": int(snap.count),
    }


def hist_from_doc(doc: dict) -> HistogramSnapshot:
    """The inverse of :func:`hist_doc` — a real
    :class:`HistogramSnapshot`, so replay code can ``.sample()`` /
    ``.quantile()`` a recorded distribution directly."""
    buckets = tuple(math.inf if b is None else float(b)
                    for b in doc.get("buckets", ()))
    counts = tuple(int(c) for c in doc.get("counts", ()))
    return HistogramSnapshot(buckets, counts,
                             float(doc.get("sum", 0.0)),
                             int(doc.get("count", 0)))


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


class UsageLedger:
    """Bounded snapshot ring + periodic ticker + exit flush.

    Thread-safe: the ticker thread (or the engine's step loop) appends
    while the telemetry thread serves ``doc()`` and the atexit hook
    flushes. Snapshot content comes from registered sources — each a
    zero-arg callable returning a partial dict; ``tenants`` and
    ``counters`` keys deep-merge so one snapshot can combine an engine
    source and a router source."""

    def __init__(self, clock=time.monotonic,
                 interval_s: float | None = None,
                 max_snapshots: int | None = None,
                 registry: Registry | None = None,
                 role: str | None = None, host: str | None = None) -> None:
        self._clock = clock
        self.interval_s = float(interval_s) if interval_s else (
            usage_interval())
        self.max_snapshots = int(max_snapshots) if max_snapshots else (
            usage_ring())
        self.role = (role or tracing.fleet_role()).strip().lower()
        self.host = host or socket.gethostname()
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(1, self.max_snapshots))
        self._sources: list[tuple[str, object]] = []
        self._seq = 0
        self._last_t: float | None = None
        # wall-clock anchor: snapshots carry both clocks so synthetic
        # monotonic timelines still export sensible unix stamps
        self._t0_mono = self._clock()
        self._t0_unix = time.time()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._c_snapshots = None
        if registry is not None:
            self._c_snapshots = registry.counter(
                "m2kt_usage_snapshots_total",
                "Usage-ledger snapshots taken by this pod")

    # -- sources -----------------------------------------------------------

    def add_source(self, fn, name: str = "") -> "UsageLedger":
        """Register one snapshot source (zero-arg callable returning a
        partial snapshot dict). Returns self for chaining."""
        self._sources.append((name or getattr(fn, "__name__", "source"),
                              fn))
        return self

    # -- recording ---------------------------------------------------------

    def _unix(self, t_mono: float) -> float:
        return self._t0_unix + (t_mono - self._t0_mono)

    def snapshot(self, t: float | None = None) -> dict:
        """Take one snapshot unconditionally: merge every source into
        the base record and append it to the ring. A raising source is
        skipped (noted under ``errors``) — billing must degrade, never
        take the workload down."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            self._seq += 1
            seq = self._seq
        snap: dict = {
            "seq": seq,
            "t_mono": now,
            "t_unix": round(self._unix(now), 6),
            "role": self.role,
            "host": self.host,
            "pid": os.getpid(),
            "tenants": {},
            "counters": {},
        }
        errors = []
        for name, fn in list(self._sources):
            try:
                part = fn() or {}
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                errors.append(f"{name}: {e}")
                continue
            for key, value in part.items():
                if key == "tenants" and isinstance(value, dict):
                    for tenant, fields in value.items():
                        snap["tenants"].setdefault(
                            str(tenant), {}).update(fields)
                elif key == "counters" and isinstance(value, dict):
                    snap["counters"].update(value)
                else:
                    snap[key] = value
        if errors:
            snap["errors"] = errors
        with self._lock:
            self._ring.append(snap)
            self._last_t = now
        if self._c_snapshots is not None:
            self._c_snapshots.inc()
        return snap

    def maybe_snapshot(self, t: float | None = None) -> dict | None:
        """Snapshot iff at least ``interval_s`` has passed since the
        last one — the idempotent tick the serve loop (or the ticker
        thread) calls as often as it likes."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            due = (self._last_t is None
                   or now - self._last_t >= self.interval_s)
        return self.snapshot(t=now) if due else None

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshots(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def window(self, window_s: float,
               now: float | None = None) -> list[dict]:
        """Snapshots whose monotonic stamp falls inside the trailing
        window — the slice a diagnostic bundle freezes."""
        if now is None:
            now = self._clock()
        floor = now - float(window_s)
        with self._lock:
            return [s for s in self._ring if s["t_mono"] >= floor]

    def doc(self, window_s: float | None = None) -> dict:
        """The ring as one self-describing JSON document — what
        ``GET /usage`` serves and what the aggregator scrapes."""
        snaps = (self.window(window_s) if window_s is not None
                 else self.snapshots())
        return {
            "schema": SCHEMA,
            "host": self.host,
            "role": self.role,
            "pid": os.getpid(),
            "written_unix": time.time(),
            "interval_s": self.interval_s,
            "max_snapshots": self.max_snapshots,
            "snapshots": snaps,
        }

    # -- flush -------------------------------------------------------------

    def flush(self, path: str | None = None) -> str | None:
        """Atomic JSONL dump: one header line (the doc sans snapshots)
        then one line per snapshot — greppable, streamable, and the
        whole file still lands or doesn't (tmp + rename). Best-effort:
        this runs on dying-process paths."""
        path = path or usage_path()
        doc = self.doc()
        snaps = doc.pop("snapshots")
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(doc, separators=(",", ":")) + "\n")
                for snap in snaps:
                    f.write(json.dumps(snap, separators=(",", ":")) + "\n")
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    # -- ticker ------------------------------------------------------------

    def start(self) -> "UsageLedger":
        """Spawn the daemon ticker (one snapshot per interval). Safe to
        call once; tests drive :meth:`snapshot` directly instead."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="m2kt-usage-ledger", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.snapshot()
            except Exception:  # noqa: BLE001 - ticker must never die noisy
                pass

    def close(self) -> None:
        self._stop.set()


def load_jsonl(path: str) -> dict:
    """Read one ``m2kt-usage.jsonl`` flush back into the ``doc()``
    shape (header + snapshots). Tolerates a missing header (plain
    snapshot lines) and skips unparsable lines."""
    header: dict = {}
    snaps: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("schema") == SCHEMA and "snapshots" not in rec:
                header = rec
            else:
                snaps.append(rec)
    doc = dict(header) if header else {"schema": SCHEMA}
    doc["snapshots"] = snaps
    return doc


# ---------------------------------------------------------------------------
# standard sources
# ---------------------------------------------------------------------------


def _samples_by_tenant(family) -> dict[str, float]:
    """{tenant: value} off a single-label family's samples()."""
    out: dict[str, float] = {}
    if family is None:
        return out
    try:
        for values, value in family.samples():
            if values:
                out[values[0]] = out.get(values[0], 0.0) + value
    except Exception:  # noqa: BLE001 - source reads are best-effort
        pass
    return out


def _hists_by_tenant(family) -> dict[str, dict]:
    out: dict[str, dict] = {}
    if family is None:
        return out
    try:
        for values, snap in family.snapshots().items():
            if values:
                out[values[0]] = hist_doc(snap)
    except Exception:  # noqa: BLE001 - source reads are best-effort
        pass
    return out


def engine_source(engine):
    """Snapshot adapter over a ServingEngine: occupancy gauges,
    ``weights_version``, scheduler counters, and the per-tenant request
    counts, attainment, and latency/length histogram snapshots. Every
    read is ``getattr``-tolerant so an engine predating a field (or a
    non-engine stand-in in tests) degrades instead of raising."""

    def read() -> dict:
        gauge_snap = dict(getattr(engine, "_gauge_snapshot", {}) or {})
        out: dict = {
            "weights_version": int(getattr(engine, "weights_version", 0)),
            "slot_occupancy": float(gauge_snap.get("slot_occupancy", 0.0)),
            "queue_depth": float(gauge_snap.get("queue_depth", 0.0)),
            "active_slots": float(gauge_snap.get("active_slots", 0.0)),
            "counters": {},
            "tenants": {},
        }
        for attr, key in (("_sched_preempted", "preempted"),
                          ("_sched_chunked", "chunked"),
                          ("_sched_throttled", "throttled"),
                          ("_admitted", "admitted"),
                          ("_rejected", "rejected"),
                          ("_decode_tokens", "decode_tokens")):
            fam = getattr(engine, attr, None)
            if fam is not None:
                try:
                    out["counters"][key] = fam.total()
                except Exception:  # noqa: BLE001
                    pass
        tenants = out["tenants"]
        for attr, field in (("_tenant_admitted", "requests"),
                            ("_tenant_rejected", "rejected")):
            for tenant, value in _samples_by_tenant(
                    getattr(engine, attr, None)).items():
                tenants.setdefault(tenant, {})[field] = value
        for attr, field in (("_tenant_ttft", "ttft"),
                            ("_tenant_lat", "token_latency"),
                            ("_tenant_prompt_tokens", "prompt_tokens"),
                            ("_tenant_decode_tokens", "decode_tokens")):
            for tenant, doc in _hists_by_tenant(
                    getattr(engine, attr, None)).items():
                tenants.setdefault(tenant, {})[field] = doc
        slo = getattr(engine, "slo", None)
        if slo is not None:
            try:
                for tenant in slo.tenants():
                    tenants.setdefault(tenant, {})["attainment"] = (
                        slo.attainment(tenant=tenant))
            except Exception:  # noqa: BLE001
                pass
        return out

    return read


def router_source(router):
    """Snapshot adapter over a fleet Router: the per-tenant net token
    demand (admitted minus unused corrections) that chargeback
    allocates card-seconds by."""

    def read() -> dict:
        admitted = _samples_by_tenant(
            getattr(router, "_admitted_tokens", None))
        unused = _samples_by_tenant(
            getattr(router, "_admitted_unused", None))
        tenants: dict[str, dict] = {}
        for tenant, value in admitted.items():
            tenants.setdefault(tenant, {})["admitted_tokens"] = value
        for tenant, value in unused.items():
            tenants.setdefault(tenant, {})["unused_tokens"] = value
        out: dict = {"tenants": tenants, "counters": {}}
        try:
            out["counters"]["admitted_tokens_net"] = float(
                router.admitted_tokens())
        except Exception:  # noqa: BLE001
            pass
        return out

    return read


# ---------------------------------------------------------------------------
# exit flush (the flight-recorder path)
# ---------------------------------------------------------------------------

_flush_installed = False


def install_usage_flush(ledger: UsageLedger,
                        path: str | None = None) -> None:
    """Flush the ledger on every teardown-running exit path — the same
    ``threading._register_atexit`` trick as ``tracing.install_ring_flush``
    (plain atexit runs after thread joins, too late for a dying serve
    loop), so a pod killed between scrapes still leaves
    ``m2kt-usage.jsonl`` for the aggregator. A final snapshot is taken
    first so the file includes the counters at death."""
    global _flush_installed
    if _flush_installed or not enabled():
        return
    _flush_installed = True

    def _flush() -> None:
        try:
            ledger.snapshot()
            ledger.flush(path)
        except Exception:  # noqa: BLE001 - dying process, best effort
            pass

    register = getattr(threading, "_register_atexit", None)
    if register is None:
        import atexit

        atexit.register(_flush)
    else:
        register(_flush)
