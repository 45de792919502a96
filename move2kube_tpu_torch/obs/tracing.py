"""Runtime tracing: a bounded span ring and its flight-recorder dump, the
port's own copy of ``move2kube_tpu/obs/tracing.py``.

Every span carries a 32-hex trace id and a 16-hex span id (W3C-sized),
so a replica's ``serve.request`` root can adopt the trace of the caller's
``traceparent`` header and the fleet's rings stitch into one trace.
Span endpoints are ``time.perf_counter()`` readings (monotonic); one
wall-clock anchor taken when the recorder is built maps them to unix time
for :meth:`SpanRecorder.snapshot`.

The ring is bounded twice: completed spans older than ``ring_seconds``
(``M2KT_TRACE_RING_SECONDS``, default 120) and any past ``max_spans`` are
evicted on append. Recording is a dict append under a lock. Tracing is on
unless ``M2KT_TRACE`` is ``0``, ``false`` or ``off``.

Every span also carries ``M2KT_SLICE_ID``/hostname/role resource tags,
so rings flushed by different processes can be merged and still
attributed. Exports:

- :meth:`SpanRecorder.chrome_trace`: Chrome trace-event JSON (``ph: "X"``
  complete events, µs timestamps), loadable in Perfetto;
- :meth:`SpanRecorder.otlp_lines`: OTLP/JSON-shaped lines, one
  ``resourceSpans`` object per line;
- :meth:`SpanRecorder.ring_doc`: the document ``/traces`` serves and
  :meth:`SpanRecorder.flush_ring` dumps atomically to ``<flight>.ring``
  for the supervisor's flight recorder (:func:`install_ring_flush` does
  it on every exit path that runs interpreter teardown).
"""

from __future__ import annotations

import contextvars
import json
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager

TRACE_ENV = "M2KT_TRACE"
# the W3C header a span's identity rides between processes
TRACEPARENT_HEADER = "traceparent"
RING_SECONDS_ENV = "M2KT_TRACE_RING_SECONDS"
FLIGHT_PATH_ENV = "M2KT_FLIGHT_PATH"
ROLE_ENV = "M2KT_FLEET_ROLE"

DEFAULT_RING_SECONDS = 120.0
# hard cap regardless of ring_seconds: an engine decoding many steps a
# second must not hold every one of them because the window says so
DEFAULT_MAX_SPANS = 8192


def enabled() -> bool:
    """Tracing defaults on: the recorder is a bounded dict append."""
    return os.environ.get(TRACE_ENV, "1").lower() not in ("0", "false", "off")


def ring_seconds() -> float:
    raw = os.environ.get(RING_SECONDS_ENV, "")
    try:
        val = float(raw) if raw else DEFAULT_RING_SECONDS
    except ValueError:
        return DEFAULT_RING_SECONDS
    return val if val > 0 else DEFAULT_RING_SECONDS


def flight_path() -> str:
    """Where the supervisor writes ``m2kt-flight.json`` (and, derived,
    where a dying process flushes its span ring for the supervisor to
    pick up): ``M2KT_FLIGHT_PATH``, else ``m2kt-flight.json`` under
    ``M2KT_METRICS_DIR`` (or the working directory)."""
    p = os.environ.get(FLIGHT_PATH_ENV, "")
    if p:
        return p
    return os.path.join(os.environ.get("M2KT_METRICS_DIR", "") or ".",
                        "m2kt-flight.json")


def ring_path() -> str:
    """The ring dump's path: the supervisor and the supervised process
    compute the same name from the same env, no handshake."""
    return flight_path() + ".ring"


def fleet_role() -> str:
    """The role this process plays in the fleet (``M2KT_FLEET_ROLE``);
    ``train`` by default."""
    role = os.environ.get(ROLE_ENV, "").strip().lower()
    return role if role else "train"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """Validate a W3C ``traceparent`` header and return
    ``(trace_id, parent_span_id)``, or None for anything malformed:
    request headers are untrusted input, and a bad one starts a fresh
    trace rather than raising on the serving path."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if (len(version), len(trace_id), len(span_id)) != (2, 32, 16):
        return None
    if len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        int(flags, 16)
    except ValueError:
        return None
    # version ff is reserved-invalid; all-zero ids mean "no parent"
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One timed operation. ``t0``/``t1`` are perf_counter readings of
    the owning recorder's clock; ``t1 is None`` while in flight."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "attrs", "_token")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str, t0: float, attrs: dict | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: float | None = None
        self.attrs: dict = dict(attrs) if attrs else {}
        self._token = None

    def traceparent(self) -> str:
        """This span's identity as a W3C ``traceparent`` header value
        (sampled flag always set: the ring is the sampler)."""
        return f"00-{self.trace_id}-{self.span_id}-01"


class SpanRecorder:
    """Thread-safe bounded ring of completed spans + in-flight set.

    Completed spans older than ``ring_seconds`` (or beyond ``max_spans``)
    are evicted on append, so memory is O(window), not O(run length).
    In-flight spans are kept apart and reported by :meth:`snapshot`."""

    def __init__(self, ring_seconds: float | None = None,
                 max_spans: int = DEFAULT_MAX_SPANS,
                 host: str | None = None, slice_id: int | None = None,
                 role: str | None = None):
        self._lock = threading.Lock()
        self._ring: deque[Span] = deque()
        self._active: dict[str, Span] = {}
        self.max_spans = max(1, int(max_spans))
        self.ring_seconds = float(ring_seconds) if ring_seconds else (
            globals()["ring_seconds"]())
        # wall-clock anchor for export; all span math stays monotonic
        self._t0_perf = time.perf_counter()
        self._t0_unix = time.time()
        self.host = host or socket.gethostname()
        if slice_id is None:
            try:
                slice_id = int(os.environ.get("M2KT_SLICE_ID", "0") or 0)
            except ValueError:
                slice_id = 0
        self.slice_id = slice_id
        self.role = (role or fleet_role()).strip().lower()
        self.dropped = 0
        # per-recorder context: nested start() calls parent automatically
        # within one thread without threading ids through call sites
        self._current: contextvars.ContextVar[Span | None] = (
            contextvars.ContextVar(f"m2kt_span_{id(self)}", default=None))

    def start(self, name: str, attrs: dict | None = None,
              parent: Span | None = None, trace_id: str | None = None,
              detached: bool = False,
              remote_parent: str | None = None) -> Span:
        """Open a span. Parent/trace identity comes from (in order) a
        ``remote_parent`` W3C traceparent header (the span adopts the
        remote trace id and parents under the remote span), the explicit
        args, the calling context's current span, or a fresh root trace.
        The new span becomes the context's current span, unless
        ``detached``, which neither inherits nor sets the context (the
        serving engine interleaves many live request traces in one thread
        and threads identity explicitly instead). A malformed
        ``remote_parent`` is ignored, not raised."""
        remote = parse_traceparent(remote_parent) if remote_parent else None
        if remote is not None:
            trace_id, parent_id = remote
        else:
            if parent is None and not detached:
                parent = self._current.get()
            if parent is not None:
                trace_id = trace_id or parent.trace_id
                parent_id = parent.span_id
            else:
                trace_id = trace_id or _new_id(16)
                parent_id = ""
        span = Span(name, trace_id, _new_id(8), parent_id,
                    time.perf_counter(), attrs)
        if not detached:
            span._token = self._current.set(span)
        with self._lock:
            self._active[span.span_id] = span
        return span

    def end(self, span: Span, attrs: dict | None = None) -> Span:
        span.t1 = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        if span._token is not None:
            try:
                self._current.reset(span._token)
            except ValueError:
                self._current.set(None)  # ended from another context
            span._token = None
        with self._lock:
            self._active.pop(span.span_id, None)
            self._append_locked(span)
        return span

    @contextmanager
    def span(self, name: str, attrs: dict | None = None,
             parent: Span | None = None, trace_id: str | None = None):
        s = self.start(name, attrs, parent=parent, trace_id=trace_id)
        try:
            yield s
        finally:
            self.end(s)

    def record(self, name: str, t0: float, t1: float,
               attrs: dict | None = None, trace_id: str | None = None,
               parent_id: str = "") -> Span:
        """Append an already-timed span from explicit perf_counter
        endpoints: the serving engine times prefill and decode itself and
        hands the *same* readings to its histograms and to the trace."""
        span = Span(name, trace_id or _new_id(16), _new_id(8), parent_id,
                    t0, attrs)
        span.t1 = t1
        with self._lock:
            self._append_locked(span)
        return span

    @staticmethod
    def annotate(span: Span, **attrs) -> None:
        span.attrs.update(attrs)

    def current(self) -> Span | None:
        return self._current.get()

    def _append_locked(self, span: Span) -> None:
        self._ring.append(span)
        horizon = time.perf_counter() - self.ring_seconds
        while self._ring and (
                len(self._ring) > self.max_spans
                or (self._ring[0].t1 is not None
                    and self._ring[0].t1 < horizon)):
            self._ring.popleft()
            self.dropped += 1

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._active.clear()
            self.dropped = 0

    def _unix(self, t: float) -> float:
        return self._t0_unix + (t - self._t0_perf)

    def snapshot(self) -> list[dict]:
        """Completed + in-flight spans as plain dicts (oldest first);
        in-flight spans report the duration so far and ``in_flight``."""
        now = time.perf_counter()
        with self._lock:
            spans = list(self._ring) + sorted(
                self._active.values(), key=lambda s: s.t0)
        out = []
        for s in spans:
            end = s.t1 if s.t1 is not None else now
            out.append({
                "name": s.name,
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "ts_unix": round(self._unix(s.t0), 6),
                "dur_s": round(end - s.t0, 9),
                "in_flight": s.t1 is None,
                "role": self.role,
                "attrs": dict(s.attrs),
            })
        return out

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON: ``ph: "X"`` complete events with µs
        timestamps, pid = this process, tid = the slice id."""
        pid = os.getpid()
        events = []
        for s in self.snapshot():
            events.append({
                "name": s["name"],
                "ph": "X",
                "ts": round((s["ts_unix"] - self._t0_unix) * 1e6, 3),
                "dur": round(s["dur_s"] * 1e6, 3),
                "pid": pid,
                "tid": self.slice_id,
                "cat": "m2kt",
                "args": {**s["attrs"], "trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"],
                         "role": s["role"]},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"host": self.host, "slice_id": self.slice_id,
                          "role": self.role,
                          "anchor_unix": self._t0_unix},
        }

    def otlp_lines(self) -> list[str]:
        """OTLP/JSON-shaped lines: one ``resourceSpans`` object per line
        (filelog-receiver friendly), string/int attributes only."""
        resource_attrs = [
            {"key": "host.name", "value": {"stringValue": self.host}},
            {"key": "m2kt.slice_id",
             "value": {"intValue": str(self.slice_id)}},
            {"key": "m2kt.role", "value": {"stringValue": self.role}},
            {"key": "service.name", "value": {"stringValue": "move2kube-tpu"}},
        ]
        lines = []
        for s in self.snapshot():
            attrs = []
            for k, v in s["attrs"].items():
                if isinstance(v, bool):
                    attrs.append({"key": k, "value": {"boolValue": v}})
                elif isinstance(v, int):
                    attrs.append({"key": k, "value": {"intValue": str(v)}})
                elif isinstance(v, float):
                    attrs.append({"key": k, "value": {"doubleValue": v}})
                else:
                    attrs.append({"key": k,
                                  "value": {"stringValue": str(v)}})
            start_ns = int(s["ts_unix"] * 1e9)
            lines.append(json.dumps({"resourceSpans": [{
                "resource": {"attributes": resource_attrs},
                "scopeSpans": [{
                    "scope": {"name": "m2kt.obs.tracing"},
                    "spans": [{
                        "traceId": s["trace_id"],
                        "spanId": s["span_id"],
                        "parentSpanId": s["parent_id"],
                        "name": s["name"],
                        "kind": 1,
                        "startTimeUnixNano": str(start_ns),
                        "endTimeUnixNano": str(
                            start_ns + int(s["dur_s"] * 1e9)),
                        "attributes": attrs,
                    }],
                }],
            }]}, separators=(",", ":")))
        return lines

    def ring_doc(self, limit: int | None = None) -> dict:
        """The ring as one self-describing JSON document: what the flight
        recorder dumps and ``/traces`` serves. ``limit`` keeps the NEWEST
        ``limit`` spans; ``truncated`` counts what it cut and ``dropped``
        what ring eviction already lost."""
        spans = self.snapshot()
        truncated = 0
        if limit is not None and limit >= 0 and len(spans) > limit:
            truncated = len(spans) - limit
            spans = spans[len(spans) - limit:]
        return {
            "host": self.host,
            "slice_id": self.slice_id,
            "role": self.role,
            "pid": os.getpid(),
            "written_unix": time.time(),
            "ring_seconds": self.ring_seconds,
            "dropped": self.dropped,
            "truncated": truncated,
            "spans": spans,
        }

    def flush_ring(self, path: str | None = None) -> str | None:
        """Atomically dump :meth:`ring_doc` (``ring_path()`` by default).
        Best-effort: this runs on dying-process paths and must never mask
        the original exit code; None when the write failed."""
        path = path or ring_path()
        doc = self.ring_doc()
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except OSError:
            return None


_recorder: SpanRecorder | None = None
_recorder_lock = threading.Lock()


def get() -> SpanRecorder:
    """Process-wide recorder (lazy: env knobs are read at first use)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = SpanRecorder()
    return _recorder


def reset() -> None:
    global _recorder
    with _recorder_lock:
        _recorder = None


_flush_installed = False


def install_ring_flush(path: str | None = None) -> None:
    """Flush the process-wide span ring on every interpreter exit path
    that runs teardown. ``threading._register_atexit`` hooks run before
    the interpreter joins non-daemon threads, where plain ``atexit`` runs
    after them, too late for a process that exits from a worker thread
    or with ``sys.exit(83)`` mid-run. SIGKILL skips teardown. Once per
    process; a no-op while tracing is off."""
    global _flush_installed
    if _flush_installed or not enabled():
        return
    _flush_installed = True

    def _flush() -> None:
        try:
            if _recorder is not None:
                _recorder.flush_ring(path)
        except Exception:  # noqa: BLE001 - dying process, best effort
            pass

    register = getattr(threading, "_register_atexit", None)
    if register is None:
        import atexit

        atexit.register(_flush)
    else:
        register(_flush)
