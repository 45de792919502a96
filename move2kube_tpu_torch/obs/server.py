"""Stdlib-HTTP telemetry server: /metrics, /healthz, /readyz, /profile,
/traces, /usage. The port's own copy of ``move2kube_tpu/obs/server.py``:
the same endpoints, env names and replies.

One daemon thread per process (ThreadingHTTPServer: a slow profiler
capture must not block a concurrent scrape). ``/profile?seconds=N``
records ``torch.profiler`` (CPU and, with a card, CUDA activities) for N
seconds into a Chrome trace under ``M2KT_PROFILE_DIR``, where the
reference drives ``jax.profiler``; torch is imported only there.

Liveness vs readiness are distinct probes: ``/healthz`` answers 200
whenever the process (and this thread) is alive, while ``/readyz``
reports the workload's state (``starting`` / ``serving`` / ``draining``)
through a caller-supplied provider and returns 503 until it says
``serving``.

``/traces`` serves the span ring as the document the flight recorder
dumps; ``/traces?clear=1`` drains it (snapshot, then reset), so repeated
collector pulls do not double-count. ``/usage`` serves the usage
ledger's document.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from move2kube_tpu_torch.obs.metrics import Registry, default_registry

METRICS_PORT_ENV = "M2KT_METRICS_PORT"
PROFILE_DIR_ENV = "M2KT_PROFILE_DIR"
DEFAULT_METRICS_PORT = 9090
DEFAULT_PROFILE_DIR = "/tmp/m2kt-profile"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
MAX_PROFILE_SECONDS = 120.0

# default /traces response bound: the ring window at a generous span
# rate. A decode engine emits a handful of spans per request, so 64/s
# covers a busy replica; an operator chasing more passes ?limit=N.
TRACE_SPANS_PER_SECOND = 64


def default_trace_limit() -> int:
    """Span cap for an unqualified ``/traces`` pull, derived from the
    ring window (``M2KT_TRACE_RING_SECONDS``) so the default response
    stays proportional to what the ring can hold."""
    from move2kube_tpu_torch.obs import tracing

    return max(1, int(tracing.ring_seconds() * TRACE_SPANS_PER_SECOND))


def profile_to(profile_dir: str, seconds: float) -> str:
    """Record ``torch.profiler`` (CPU, and CUDA when a card is present)
    for ``seconds`` and write its Chrome trace into ``profile_dir``;
    returns the file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(seconds)
    path = os.path.join(profile_dir, f"m2kt-profile-{os.getpid()}-"
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def metrics_port_from_env(default: int = 0) -> int:
    """Resolve the telemetry port: env wins, else the baked-in default;
    0 (or garbage) means disabled."""
    raw = os.environ.get(METRICS_PORT_ENV, "")
    try:
        return int(raw) if raw.strip() else int(default)
    except (TypeError, ValueError):
        return 0


class TelemetryServer:
    """Owns the HTTP listener + its serve thread. ``port=0`` binds an
    OS-assigned port (tests); ``.port`` is the bound port either way."""

    def __init__(self, port: int = 0, registry: Registry | None = None,
                 profile_dir: str | None = None,
                 readiness=None, tracer=None, ledger=None) -> None:
        self.registry = registry if registry is not None else default_registry()
        # span recorder served by /traces; None falls back to the
        # process-wide recorder iff tracing is enabled
        self._tracer = tracer
        # usage ledger served by /usage (set_ledger post-construction:
        # the serve template builds the server before the engine exists)
        self._ledger = ledger
        self.profile_dir = (profile_dir
                            or os.environ.get(PROFILE_DIR_ENV, "")
                            or DEFAULT_PROFILE_DIR)
        # readiness provider: a zero-arg callable returning "starting" /
        # "serving" / "draining". None keeps /readyz always-ready for
        # back-compat (trainers have no warm-up gate to report).
        self._readiness = readiness
        self._profile_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - http.server API
                server._route(self)

            def log_message(self, fmt, *args) -> None:
                pass  # scrapes every 15s would spam stderr

        self._httpd = ThreadingHTTPServer(("0.0.0.0", int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="m2kt-telemetry",
            daemon=True)

    def start(self) -> "TelemetryServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- routing ----------------------------------------------------------

    def _route(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        if parsed.path == "/metrics":
            self._send(req, 200, self.registry.render(), CONTENT_TYPE)
        elif parsed.path == "/healthz":
            # liveness only: reachable == alive; workload state belongs
            # to /readyz (a compiling model must not be restart-killed)
            self._send(req, 200, "ok\n")
        elif parsed.path == "/readyz":
            self._handle_readyz(req)
        elif parsed.path == "/profile":
            self._handle_profile(req, parse_qs(parsed.query))
        elif parsed.path == "/traces":
            self._handle_traces(req, parse_qs(parsed.query))
        elif parsed.path == "/usage":
            self._handle_usage(req, parse_qs(parsed.query))
        else:
            self._send(req, 404, "not found\n")

    def set_readiness(self, readiness) -> None:
        """Install/replace the readiness provider after construction (the
        serve template builds the server before the engine exists)."""
        self._readiness = readiness

    def set_tracer(self, tracer) -> None:
        """Install/replace the span recorder served by ``/traces`` (same
        post-construction shape as ``set_readiness``)."""
        self._tracer = tracer

    def set_ledger(self, ledger) -> None:
        """Install/replace the usage ledger served by ``/usage``."""
        self._ledger = ledger

    def _handle_traces(self, req, query: dict) -> None:
        from move2kube_tpu_torch.obs import tracing

        tracer = self._tracer
        if tracer is None and tracing.enabled():
            tracer = tracing.get()
        if tracer is None:
            self._send(req, 404, "tracing disabled\n")
            return
        try:
            limit = int(query.get("limit", [""])[0] or default_trace_limit())
        except (TypeError, ValueError):
            self._send(req, 400, "limit must be an integer\n")
            return
        doc = tracer.ring_doc(limit=max(0, limit))
        if query.get("clear", ["0"])[0] not in ("0", "", "false"):
            tracer.clear()
        self._send(req, 200, json.dumps(doc) + "\n", "application/json")

    def _handle_usage(self, req, query: dict) -> None:
        ledger = self._ledger
        if ledger is None:
            self._send(req, 404, "usage ledger disabled\n")
            return
        try:
            window = float(query.get("window", ["0"])[0] or 0)
        except (TypeError, ValueError):
            self._send(req, 400, "window must be a number\n")
            return
        try:
            doc = ledger.doc(window_s=window if window > 0 else None)
        except Exception as e:  # noqa: BLE001 - probe must not 500
            self._send(req, 422, f"usage ledger errored: {e}\n")
            return
        self._send(req, 200, json.dumps(doc) + "\n", "application/json")

    def _handle_readyz(self, req) -> None:
        state = "serving"
        if self._readiness is not None:
            try:
                state = str(self._readiness())
            except Exception as e:  # noqa: BLE001 - probe must not 500
                self._send(req, 503, f"readiness probe errored: {e}\n")
                return
        self._send(req, 200 if state == "serving" else 503, state + "\n")

    def _handle_profile(self, req, query: dict) -> None:
        # every failure here is fail-open and non-5xx: a bad or unlucky
        # /profile request must degrade to a handled client-error reply,
        # never to a 5xx that trips alerting on the workload itself
        try:
            seconds = float(query.get("seconds", ["1"])[0])
        except (TypeError, ValueError):
            self._send(req, 400, "seconds must be a number\n")
            return
        if not 0 < seconds <= MAX_PROFILE_SECONDS:
            self._send(req, 400,
                       f"seconds must be in (0, {MAX_PROFILE_SECONDS:g}]\n")
            return
        try:
            os.makedirs(self.profile_dir, exist_ok=True)
            writable = os.access(self.profile_dir, os.W_OK)
        except OSError:
            writable = False
        if not writable:
            self._send(req, 403,
                       f"profile dir {self.profile_dir} is not writable\n")
            return
        if not self._profile_lock.acquire(blocking=False):
            self._send(req, 409, "a profile capture is already running\n")
            return
        try:
            result = self._capture(seconds)
        except Exception as e:  # noqa: BLE001 - surface, don't kill the server
            self._send(req, 422, f"profiler unavailable: {e}\n")
            return
        finally:
            self._profile_lock.release()
        self._send(req, 200, json.dumps(result, sort_keys=True) + "\n",
                   "application/json")

    def _capture(self, seconds: float) -> dict:
        os.makedirs(self.profile_dir, exist_ok=True)
        profile_to(self.profile_dir, seconds)
        return {"profile_dir": self.profile_dir, "seconds": seconds}

    @staticmethod
    def _send(req, code: int, body: str,
              content_type: str = "text/plain; charset=utf-8") -> None:
        payload = body.encode("utf-8")
        req.send_response(code)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)


def start_telemetry_server(port: int | None = None,
                           registry: Registry | None = None,
                           profile_dir: str | None = None,
                           readiness=None,
                           tracer=None, ledger=None) -> TelemetryServer | None:
    """Start the telemetry server. ``port=None`` resolves from
    ``M2KT_METRICS_PORT`` and returns None when that says disabled (0 /
    unset) — the shape the emitted templates use. An explicit ``port=0``
    means "any free port" (tests)."""
    if port is None:
        port = metrics_port_from_env(0)
        if port <= 0:
            return None
    try:
        return TelemetryServer(port=port, registry=registry,
                               profile_dir=profile_dir,
                               readiness=readiness, tracer=tracer,
                               ledger=ledger).start()
    except OSError:
        # never kill a training run over a busy metrics port
        return None
