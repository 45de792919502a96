"""Fleet request router of the port: prefix-affine load balancing over N
engine replicas (the port's own copy of
``move2kube_tpu/serving/fleet/router.py``, over the port's engine).

Placement is the fleet's cache policy: the prefix cache
(:mod:`move2kube_tpu_torch.serving.prefixcache`) lives *inside* each
replica, so a request only
hits if earlier requests with the same prefix landed on the same
replica. The router therefore routes by **session affinity on the
prefix hash** — rendezvous (highest-random-weight) hashing of the
first ``affinity_tokens`` prompt tokens plus a salt, which keeps the
tenant->replica mapping stable as replicas come and go (only keys
owned by a dead replica move). When the affine replica is unhealthy or
its queue is deep, the router spills to the least-loaded healthy
replica; failures mark the replica down and retry elsewhere (bounded),
and an optional hedge fires a duplicate to the runner-up when the
primary sits on a request too long.

Fault tolerance: the router
keeps a per-request **journal** of every token a replica has streamed
(the engine's ``on_token`` hook feeds it); when a replica dies
mid-stream the journaled tokens are force-fed as a prompt suffix on a
surviving replica — greedy decode is deterministic and the prefix
cache makes the re-prefill cheap — so the resumed stream is
byte-identical to an uninterrupted run (``m2kt_router_resumed_total``
counts them by failure reason). Deadlines propagate router -> replica
-> engine via the ``X-M2KT-Deadline`` header carrying the *remaining*
budget in seconds (skew-free: recomputed at each hop), and every wait
in this file derives from it — there are no hard-coded request
timeouts. Replicas drain gracefully (finish in-flight, refuse new,
flip ``/readyz``), and readmission probes back off exponentially with
deterministic jitter so a restarting replica is not thundering-herded.

Everything observable exports as ``m2kt_router_*`` through the port's
metrics registry; the HTTP front serves ``/generate`` plus the standard
``/healthz``/``/readyz``/``/metrics`` trio. The router's names, metrics,
placement hash and wire formats are the JAX package's, so the same
prompts land on the same replica names.

On the card, :func:`build_fleet` puts N engines on one model (they share
its weights; each has its own KV cache and step thread), so one process
serves the fleet; the engines' passes then share the GIL and the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from move2kube_tpu_torch.obs import tracing
from move2kube_tpu_torch.obs.metrics import Registry
from move2kube_tpu_torch.obs.slo import (
    TENANT_HEADER,
    clean_tenant,
    max_tenants,
)
from move2kube_tpu_torch.obs.tracing import TRACEPARENT_HEADER
from move2kube_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineConfig,
    EngineDraining,
    Request,
    ServingEngine,
)
from move2kube_tpu_torch.serving.sched import (
    AdmissionController,
    SchedThrottled,
)

# remaining deadline budget in seconds (gRPC-style relative value, not a
# wall-clock timestamp — immune to clock skew between pods); each hop
# recomputes the remainder before forwarding
DEADLINE_HEADER = "X-M2KT-Deadline"


def probe_timeout_s() -> float:
    """Health-probe timeout (NOT a request timeout — request waits all
    derive from the propagated deadline). Probes need their own small
    bound so a hung replica cannot stall the whole probe sweep."""
    try:
        return float(os.environ.get("M2KT_PROBE_TIMEOUT_S", "") or 2.0)
    except ValueError:
        return 2.0


class ReplicaDraining(RuntimeError):
    """The replica refused (or abandoned) the request because it is
    draining. Retryable: the router re-routes to a surviving replica."""


class RequestPreempted(RuntimeError):
    """The engine evicted the request mid-stream to make room for a
    higher-priority tenant (finish_reason ``"preempted"``). Retryable
    like a replica death — the journal makes the retry a token-exact
    resume — but NOT the replica's fault: the router neither marks the
    replica down nor excludes it from the resume placement."""


class ReplicaHTTPError(RuntimeError):
    """A replica answered with a non-2xx status. Carries the status code
    and a body excerpt so the router's mark-down reason and logs say
    *what the replica said*, not just that urllib raised."""

    def __init__(self, replica: str, path: str, status: int, body: str):
        self.replica = replica
        self.path = path
        self.status = int(status)
        self.body_excerpt = (body or "").strip()[:200]
        super().__init__(
            f"{replica}{path}: HTTP {self.status}: "
            f"{self.body_excerpt or '<empty body>'}")


def failure_reason(err: Exception) -> str:
    """A bounded-cardinality label for why a replica call failed —
    the value the reason-labeled retry/mark-down counters carry."""
    if isinstance(err, ReplicaHTTPError):
        return f"http_{err.status}"
    if isinstance(err, RequestPreempted):
        return "preempted"
    if isinstance(err, SchedThrottled):
        return "throttled"
    if isinstance(err, DeadlineExceeded):
        return "deadline"
    if isinstance(err, (ReplicaDraining, EngineDraining)):
        return "draining"
    if isinstance(err, TimeoutError):
        return "timeout"
    if isinstance(err, (urllib.error.URLError, ConnectionError, OSError)):
        return "connection"
    return type(err).__name__.lower()


def prefix_hash(tokens, salt: str = "", k: int = 16) -> int:
    """Stable across processes (the Helm-lifted salt is the only input
    besides the tokens): hash of the first ``k`` prompt tokens."""
    h = hashlib.sha256(salt.encode())
    for t in list(tokens)[:k]:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return int.from_bytes(h.digest()[:8], "little")


def _rendezvous_score(key: int, name: str) -> int:
    h = hashlib.sha256(f"{key}:{name}".encode())
    return int.from_bytes(h.digest()[:8], "little")


class TokenFanout:
    """Bounded-queue stream fan-out between the engine's step thread and
    SSE/streaming subscribers.

    Every millisecond the step thread spends is a gap the device idles
    through. So the step thread's half of streaming is ONE non-blocking
    ``put_nowait`` onto a shared bounded queue; a dedicated worker
    thread drains it into per-subscriber bounded buffers. A slow SSE
    consumer can therefore never stall decode: when *its* buffer fills,
    that subscriber alone is cut with a ``lagged`` event and counted
    (``m2kt_serve_fanout_lagged_total``); if the shared queue itself
    fills (the worker is starved), tokens are counted dropped
    (``m2kt_serve_fanout_dropped_total``) rather than blocking the step.

    The router's token *journal* does NOT ride this path — journaling
    stays synchronous in the step thread because the exactness
    guarantee ("never journal a token the device hasn't committed, never
    lose one it has") depends on it. Fan-out is best-effort delivery for
    human eyeballs; the journal is the source of truth for resume.

    Subscriber protocol: :meth:`subscribe` returns a ``queue.Queue`` of
    ``("token", int)``, ``("finish", reason)`` and ``("lagged", None)``
    events; ``finish``/``lagged`` are terminal."""

    _STOP = object()

    def __init__(self, registry: Registry | None = None,
                 maxsize: int = 4096, sub_maxsize: int = 256):
        self._q: queue.Queue = queue.Queue(maxsize)
        self._subs: dict[str, list[queue.Queue]] = {}
        self._lock = threading.Lock()
        reg = registry if registry is not None else Registry()
        self._dropped = reg.counter(
            "m2kt_serve_fanout_dropped_total",
            "Stream tokens dropped because the fan-out queue was full "
            "(the step thread never blocks on streaming)")
        self._lagged = reg.counter(
            "m2kt_serve_fanout_lagged_total",
            "Streaming subscribers disconnected for falling behind")
        self._sub_maxsize = max(1, sub_maxsize)
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="token-fanout", daemon=True)
        self._thread.start()

    def subscribe(self, rid: str) -> queue.Queue:
        """Register a subscriber for ``rid``'s tokens; call BEFORE the
        request is submitted or the head of the stream may be missed."""
        sub: queue.Queue = queue.Queue(self._sub_maxsize)
        with self._lock:
            self._subs.setdefault(rid, []).append(sub)
        return sub

    def unsubscribe(self, rid: str, sub: queue.Queue) -> None:
        with self._lock:
            subs = self._subs.get(rid)
            if subs and sub in subs:
                subs.remove(sub)
                if not subs:
                    self._subs.pop(rid, None)

    def publish(self, rid: str, tok: int) -> None:
        """Step-thread half: enqueue and return, never block."""
        try:
            self._q.put_nowait(("token", rid, tok))
        except queue.Full:
            self._dropped.inc()

    def finish(self, rid: str, reason: str = "") -> None:
        try:
            self._q.put_nowait(("finish", rid, reason))
        except queue.Full:
            self._dropped.inc()

    def close(self) -> None:
        self._stop = True
        try:
            self._q.put_nowait(self._STOP)
        except queue.Full:
            pass
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP or self._stop:
                return
            kind, rid, payload = item
            with self._lock:
                subs = list(self._subs.get(rid, ()))
            for sub in subs:
                try:
                    sub.put_nowait((kind, payload))
                except queue.Full:
                    # this subscriber alone falls off the stream; the
                    # terminal marker jumps the queue so it learns why
                    self._lagged.inc()
                    try:
                        sub.queue.clear()  # make room for the marker
                        sub.put_nowait(("lagged", None))
                    except queue.Full:
                        pass
                    self.unsubscribe(rid, sub)
            if kind == "finish":
                with self._lock:
                    self._subs.pop(rid, None)


class ReplicaHandle:
    """One engine replica as the router sees it. ``deadline_s`` is the
    remaining budget for the call (None = unbounded); ``on_token`` is
    the router's journal hook — called with each token the moment the
    engine emits it, so a mid-stream death loses nothing."""

    name: str = "replica"

    def generate(self, prompt, max_new_tokens: int | None = None,
                 rid: str | None = None, tenant: str = "",
                 traceparent: str = "", deadline_s: float | None = None,
                 on_token=None, adapter: str = "") -> dict:
        raise NotImplementedError

    def queue_depth(self) -> float:
        raise NotImplementedError

    def healthy(self) -> bool:
        raise NotImplementedError


class InProcessReplica(ReplicaHandle):
    """A ServingEngine plus its worker thread: a whole fleet in one
    process, on the CPU or on one card. ``fail_next`` makes the next N
    calls raise, for failover/hedging drills."""

    def __init__(self, name: str, engine: ServingEngine):
        self.name = name
        self.engine = engine
        self.fail_next = 0
        self.hold_s = 0.0  # artificial service delay, for hedging drills
        # optional ServingChaos (serving/fleet/chaos.py): hooks into the
        # token stream / generate entry / health checks for fault drills
        self.chaos = None
        # optional TokenFanout: best-effort streaming fan-out off the
        # step thread; the journal callback above it stays synchronous
        self.fanout: TokenFanout | None = None
        self._lock = threading.Lock()
        self._waiters: dict[str, tuple[threading.Event, list]] = {}
        self._token_cbs: dict[str, object] = {}
        self._seq = 0
        self._stop = False
        self._draining = False
        self._thread: threading.Thread | None = None
        self._up = True
        engine.on_token = self._on_token

    def start(self) -> "InProcessReplica":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"replica-{self.name}", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5)

    def revive(self) -> "InProcessReplica":
        """Bring a crashed/closed replica back — the in-process stand-in
        for a restarted pod: fresh worker thread, same engine."""
        if self._thread is not None and self._thread.is_alive():
            self._stop = True
            self._thread.join(timeout=5)
        self._thread = None
        self._stop = False
        self._draining = False
        self._up = True
        self.engine.undrain()
        return self.start()

    def _on_token(self, rid: str, tok: int) -> None:
        """Engine token-emission fan-out. The caller's journal callback
        runs FIRST so a chaos kill-at-token-N still leaves token N in
        the journal — exactly the state a real mid-stream death leaves."""
        cb = self._token_cbs.get(rid)
        if cb is not None:
            cb(tok)
        if self.chaos is not None:
            self.chaos.on_token(self.name, rid, tok)
        if self.fanout is not None:
            self.fanout.publish(rid, tok)

    def _loop(self) -> None:
        while not self._stop:
            try:
                work = self._step_once()
            except Exception as err:  # noqa: BLE001 - replica "process" died
                self._crash(err)
                return
            if not work:
                time.sleep(0.002)

    def _step_once(self) -> bool:
        """One iteration of the worker loop: an engine step under the
        step lock when there is work, its completions handed to their
        waiters. Returns whether there was work. (A test may drive a
        replica whose thread is not started through this, one step at a
        time.)"""
        with self._lock:
            work = self.engine.has_work()
            done = self.engine.step() if work else []
        for comp in done:
            self._token_cbs.pop(comp.rid, None)
            waiter = self._waiters.pop(comp.rid, None)
            if waiter is not None:
                event, box = waiter
                box.append(comp)
                event.set()
        return work

    def _crash(self, err: Exception) -> None:
        """The worker thread died mid-step (the in-process equivalent of
        a replica pod crashing): go unhealthy and fail every waiter so
        no caller hangs — the router journals + resumes them."""
        self._up = False
        self._stop = True
        waiters, self._waiters = dict(self._waiters), {}
        self._token_cbs.clear()
        for _rid, (event, box) in waiters.items():
            box.append(err)
            event.set()

    def set_healthy(self, up: bool) -> None:
        self._up = up

    def healthy(self) -> bool:
        if self.chaos is not None and not self.chaos.on_probe(self.name):
            return False
        return self._up and not self._stop and not self._draining

    def queue_depth(self) -> float:
        stats = self.engine.stats()
        return float(stats["queue_depth"] + stats["active_slots"])

    def drain(self, grace_s: float = 30.0) -> bool:
        """Graceful drain: stop admitting, keep decoding until in-flight
        work finishes or the grace period lapses. Returns True when the
        replica drained clean. Requests still unfinished at the deadline
        fail their waiters with :class:`ReplicaDraining`, which the
        router treats as retryable — so even an ungraceful cutoff loses
        nothing. ``healthy()`` flips immediately, pulling the replica
        out of the placement ring."""
        self._draining = True
        self.engine.drain()
        deadline = time.perf_counter() + max(0.0, grace_s)
        while time.perf_counter() < deadline:
            if self._stop:
                break  # crashed mid-drain; _crash already failed waiters
            with self._lock:
                busy = self.engine.has_work()
            if not busy and not self._waiters:
                break
            time.sleep(0.002)
        clean = not self._waiters
        waiters, self._waiters = dict(self._waiters), {}
        self._token_cbs.clear()
        for rid, (event, box) in waiters.items():
            box.append(ReplicaDraining(
                f"{self.name}: drained before {rid} finished"))
            event.set()
        return clean

    @staticmethod
    def _result(comp) -> dict:
        if isinstance(comp, Exception):
            raise comp
        if comp.finish_reason == "shed":
            raise DeadlineExceeded(
                f"{comp.rid}: shed while queued (deadline expired)")
        if comp.finish_reason == "preempted":
            # paused work, not an error: every emitted token is already
            # in the caller's journal, so the router resumes it
            raise RequestPreempted(
                f"{comp.rid}: preempted after {len(comp.tokens)} tokens")
        return comp

    def generate(self, prompt, max_new_tokens=None, rid=None,
                 tenant: str = "", traceparent: str = "",
                 deadline_s: float | None = None, on_token=None,
                 adapter: str = "") -> dict:
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError(f"{self.name}: injected failure")
        if self._draining:
            raise ReplicaDraining(f"{self.name}: draining, not admitting")
        if self.chaos is not None:
            self.chaos.on_generate(self.name, rid or "")
        if self.hold_s:
            time.sleep(self.hold_s)
        self.start()
        with self._lock:
            self._seq += 1
            rid = rid or f"{self.name}-{self._seq}"
            event, box = threading.Event(), []
            self._waiters[rid] = (event, box)
            if on_token is not None:
                self._token_cbs[rid] = on_token
            try:
                self.engine.submit(Request(rid=rid, prompt=list(prompt),
                                           max_new_tokens=max_new_tokens,
                                           tenant=tenant,
                                           traceparent=traceparent,
                                           deadline_s=deadline_s,
                                           adapter=adapter))
            except EngineDraining as err:
                self._waiters.pop(rid, None)
                self._token_cbs.pop(rid, None)
                raise ReplicaDraining(str(err)) from err
            except Exception:
                self._waiters.pop(rid, None)
                self._token_cbs.pop(rid, None)
                raise
        # the wait derives from the propagated deadline; with none, the
        # crash/drain paths guarantee the event always fires eventually
        if not event.wait(timeout=deadline_s):
            self._waiters.pop(rid, None)
            self._token_cbs.pop(rid, None)
            raise TimeoutError(
                f"{self.name}: request {rid} missed its "
                f"{deadline_s:.3f}s deadline")
        comp = self._result(box[0])
        return {"rid": comp.rid, "replica": self.name,
                "prompt_len": comp.prompt_len, "tokens": comp.tokens,
                "finish_reason": comp.finish_reason}

    def swap(self, variables=None, version: int | None = None) -> int:
        """Live weight swap: install a new ``state_dict`` between decode
        steps (the step lock guarantees no step is in flight while the
        swap lands), and every in-flight stream decodes its next token
        with the new weights. A chaos ``on_swap``
        kill crashes the replica exactly as a pod dying mid-rolling-
        update would: waiters fail over to the router's journal/resume
        path, so even a swap death loses nothing."""
        from move2kube_tpu_torch.serving.fleet.chaos import ChaosKill

        if variables is None:
            raise ValueError(f"{self.name}: no weight source for swap")
        try:
            if self.chaos is not None:
                self.chaos.on_swap(self.name)
        except ChaosKill as err:
            self._crash(err)
            raise
        with self._lock:
            return self.engine.install_weights(variables, version)

    def install(self, handoff_bytes: bytes, tenant: str = "",
                traceparent: str = "",
                deadline_s: float | None = None) -> dict:
        """Seat a disagg KV handoff and decode it to completion. The
        handoff wire format already carries tenant/traceparent; the
        kwargs exist for signature parity with :class:`HttpReplica`."""
        from move2kube_tpu_torch.serving.fleet.disagg import KVHandoff

        if self._draining:
            raise ReplicaDraining(f"{self.name}: draining, not admitting")
        if self.chaos is not None:
            handoff_bytes = self.chaos.on_handoff(self.name, handoff_bytes)
        h = KVHandoff.from_bytes(handoff_bytes)
        event, box = threading.Event(), []
        self.start()
        installed = False
        expires = (time.perf_counter() + deadline_s
                   if deadline_s is not None else None)
        while not installed:
            if self._stop:
                raise ReplicaDraining(f"{self.name}: replica stopped")
            if expires is not None and time.perf_counter() > expires:
                raise TimeoutError(
                    f"{self.name}: handoff {h.rid} missed its "
                    f"{deadline_s:.3f}s deadline before install")
            with self._lock:
                ok, done = self.engine.install_prefilled(
                    h.request(), h.kv, h.first_token, h.prompt_len)
                if ok:
                    installed = True
                    if done:
                        box.extend(done)
                        event.set()
                    else:
                        self._waiters[h.rid] = (event, box)
            if not installed:
                time.sleep(0.002)  # engine full: let the loop drain a step
        remaining = (expires - time.perf_counter()
                     if expires is not None else None)
        if not event.wait(timeout=remaining):
            self._waiters.pop(h.rid, None)
            raise TimeoutError(
                f"{self.name}: handoff {h.rid} missed its "
                f"{deadline_s:.3f}s deadline")
        comp = self._result(box[0])
        return {"rid": comp.rid, "replica": self.name,
                "prompt_len": comp.prompt_len, "tokens": comp.tokens,
                "finish_reason": comp.finish_reason}


class HttpReplica(ReplicaHandle):
    """A remote engine pod: ``/generate`` (and ``/install`` for disagg)
    on the serving port, ``/readyz`` + ``/stats`` on the telemetry
    port."""

    def __init__(self, name: str, base_url: str,
                 health_url: str | None = None,
                 timeout_s: float | None = None):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.health_url = (health_url or base_url).rstrip("/")
        # fallback socket timeout for deadline-less calls only; every
        # deadlined call derives its timeout from the remaining budget
        self.timeout_s = timeout_s

    def _post(self, path: str, data: bytes, ctype: str,
              tenant: str = "", traceparent: str = "",
              deadline_s: float | None = None) -> bytes:
        """POST with trace/tenant/deadline header injection. A non-2xx
        answer is surfaced as :class:`ReplicaHTTPError` with the status
        and a body excerpt — urllib's bare ``HTTP Error 500`` hid what
        the replica actually said."""
        headers = {"Content-Type": ctype}
        if tenant:
            headers[TENANT_HEADER] = tenant
        if traceparent:
            headers[TRACEPARENT_HEADER] = traceparent
        if deadline_s is not None:
            headers[DEADLINE_HEADER] = f"{deadline_s:.3f}"
        timeout = deadline_s if deadline_s is not None else self.timeout_s
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as err:
            try:
                body = err.read(512).decode("utf-8", "replace")
            except OSError:
                body = ""
            raise ReplicaHTTPError(self.name, path, err.code,
                                   body) from err

    def generate(self, prompt, max_new_tokens=None, rid=None,
                 tenant: str = "", traceparent: str = "",
                 deadline_s: float | None = None, on_token=None,
                 adapter: str = "") -> dict:
        # request/response transport: there is no mid-stream token feed,
        # so ``on_token`` replays the whole completion at once — a death
        # before the reply resumes as a whole-request retry, which is
        # trivially token-exact
        body = json.dumps({"prompt": list(prompt),
                           "max_new_tokens": max_new_tokens,
                           "rid": rid, "adapter": adapter}).encode()
        out = json.loads(self._post(
            "/generate", body, "application/json",
            tenant=tenant, traceparent=traceparent,
            deadline_s=deadline_s).decode())
        if on_token is not None:
            for tok in out.get("tokens", []):
                on_token(tok)
        if out.get("finish_reason") == "preempted":
            # journal already replayed above; the raise turns the reply
            # into the same resume path the in-process replica takes
            raise RequestPreempted(
                f"{out.get('rid')}: preempted after "
                f"{len(out.get('tokens', []))} tokens")
        return out

    def install(self, handoff_bytes: bytes, tenant: str = "",
                traceparent: str = "",
                deadline_s: float | None = None) -> dict:
        return json.loads(self._post(
            "/install", handoff_bytes, "application/octet-stream",
            tenant=tenant, traceparent=traceparent,
            deadline_s=deadline_s).decode())

    def swap(self, variables=None, version: int | None = None) -> int:
        """POST /swap: the pod re-pulls its own weights (peers first,
        checkpoint-store fallback) and live-installs them. A parameter
        tree cannot ride this hop — remote swaps are pull-based."""
        if variables is not None:
            raise ValueError(
                f"{self.name}: HTTP replicas pull weights themselves; "
                "swap(variables=...) is in-process only")
        body = json.dumps({"version": version}).encode()
        out = json.loads(self._post(
            "/swap", body, "application/json").decode())
        return int(out.get("weights_version", 0))

    def prefill(self, request):
        """Disagg prefill over HTTP: POST the prompt, get back the
        serialized KV handoff (``KVHandoff.to_bytes`` wire format)."""
        from move2kube_tpu_torch.serving.fleet.disagg import KVHandoff

        body = json.dumps({"prompt": list(request.prompt),
                           "max_new_tokens": request.max_new_tokens,
                           "rid": request.rid}).encode()
        return KVHandoff.from_bytes(self._post(
            "/prefill", body, "application/json",
            tenant=request.tenant, traceparent=request.traceparent,
            deadline_s=request.deadline_s))

    def queue_depth(self) -> float:
        try:
            with urllib.request.urlopen(f"{self.health_url}/stats",
                                        timeout=probe_timeout_s()) as resp:
                stats = json.loads(resp.read().decode())
            return float(stats.get("queue_depth", 0)
                         + stats.get("active_slots", 0))
        except (OSError, ValueError):
            return float("inf")

    def healthy(self) -> bool:
        try:
            with urllib.request.urlopen(f"{self.health_url}/readyz",
                                        timeout=probe_timeout_s()) as resp:
                return resp.status == 200
        except (OSError, ValueError):
            return False


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    affinity_tokens: int = 16   # prompt prefix length hashed for affinity
    salt: str = ""              # M2KT_FLEET_AFFINITY_SALT (Helm-lifted)
    max_retries: int = 2        # additional replicas tried on failure
    spill_queue_depth: float = 8.0  # affine queue deeper than this spills
    hedge_after_s: float | None = None  # None = hedging off
    disagg_threshold: int = 0   # prompt length that routes via prefill; 0=off
    # default per-request deadline budget (M2KT_DEADLINE_S, Helm-lifted);
    # every downstream wait derives from it. None/<=0 = no deadline
    deadline_s: float | None = 120.0
    # eos id for completing a resume locally when the journal already
    # ends in eos (the engine owns eos semantics; the router only needs
    # it to avoid asking a replica to decode past the end)
    eos_id: int | None = None
    # readmission-probe exponential backoff (after FAILED probes only —
    # a fresh markdown is still probed immediately, so recovery latency
    # does not regress)
    probe_backoff_base_s: float = 0.5
    probe_backoff_cap_s: float = 30.0
    # scheduler plane: the same tenant specs the engines parse —
    # admission throttles HERE, before placement, so an over-quota
    # tenant never costs a replica round-trip. Malformed entries warn
    # and are skipped inside the sched parser (quant.py tolerance).
    sched_tenants: str = ""
    sched_priorities: str = ""
    sched_quotas: str = ""
    # how many preemption resumes one request may take before the
    # router gives up (a bound on best-effort starvation spin, NOT a
    # replica-failure retry — those stay on max_retries)
    max_preempt_resumes: int = 64

    @classmethod
    def from_env(cls, **overrides) -> "RouterConfig":
        def _num(name, default, cast):
            try:
                return cast(os.environ.get(name, "") or default)
            except ValueError:
                return default

        hedge = _num("M2KT_ROUTER_HEDGE_MS", 0.0, float)
        deadline = _num("M2KT_DEADLINE_S", cls.deadline_s or 0.0, float)
        cfg = dict(
            affinity_tokens=_num("M2KT_ROUTER_AFFINITY_TOKENS",
                                 cls.affinity_tokens, int),
            salt=os.environ.get("M2KT_FLEET_AFFINITY_SALT", cls.salt),
            max_retries=_num("M2KT_ROUTER_RETRIES", cls.max_retries, int),
            spill_queue_depth=_num("M2KT_ROUTER_SPILL_DEPTH",
                                   cls.spill_queue_depth, float),
            hedge_after_s=(hedge / 1e3) if hedge > 0 else None,
            disagg_threshold=_num("M2KT_FLEET_DISAGG_THRESHOLD", 0, int),
            deadline_s=deadline if deadline > 0 else None,
            probe_backoff_base_s=_num("M2KT_ROUTER_PROBE_BACKOFF_S",
                                      cls.probe_backoff_base_s, float),
            probe_backoff_cap_s=_num("M2KT_ROUTER_PROBE_BACKOFF_CAP_S",
                                     cls.probe_backoff_cap_s, float),
            sched_tenants=os.environ.get("M2KT_SCHED_TENANTS",
                                         cls.sched_tenants),
            sched_priorities=os.environ.get("M2KT_SCHED_PRIORITIES",
                                            cls.sched_priorities),
            sched_quotas=os.environ.get("M2KT_SCHED_QUOTAS",
                                        cls.sched_quotas),
            max_preempt_resumes=_num("M2KT_ROUTER_PREEMPT_RESUMES",
                                     cls.max_preempt_resumes, int),
        )
        cfg.update(overrides)
        return cls(**cfg)


class Router:
    def __init__(self, replicas, config: RouterConfig | None = None,
                 prefill_replicas=(), registry: Registry | None = None,
                 tracer=None):
        self.replicas = list(replicas)
        self.prefill_replicas = list(prefill_replicas)
        self.config = config or RouterConfig()
        self.registry = registry if registry is not None else Registry()
        # the router's span ring: every routed request opens a
        # router.request root, every replica hop a router.call child
        # whose traceparent() rides the outbound headers
        self.tracer = tracer if tracer is not None else (
            tracing.get() if tracing.enabled() else None)
        # last-known health, refreshed by probe(); a failed call marks
        # the replica down immediately without waiting for a probe
        self._up: dict[str, bool] = {r.name: True for r in self.replicas}
        self._rr = 0  # round-robin cursor over prefill replicas
        # scheduler plane: the router front runs admission (token-bucket
        # throttling) against the same specs the engines parse, so the
        # two sides can never disagree on who a tenant is
        self.admission = AdmissionController.from_specs(
            self.config.sched_tenants, self.config.sched_priorities,
            self.config.sched_quotas, registry=self.registry)
        # readmission-probe backoff: replica -> (consecutive failed
        # probes, monotonic ts before which it is not probed again)
        self._probe_state: dict[str, tuple[int, float]] = {}
        reg = self.registry
        self._requests = reg.counter(
            "m2kt_router_requests_total", "Routed requests by outcome",
            labels=("outcome",))
        self._resumed = reg.counter(
            "m2kt_router_resumed_total",
            "Mid-stream requests resumed on a surviving replica with "
            "their journaled tokens force-fed, by failure reason",
            labels=("reason",))
        self._sched_resumed = reg.counter(
            "m2kt_sched_resumed_total",
            "Preempted requests resumed token-exactly from the journal, "
            "by the reason the resume was needed", labels=("reason",))
        self._retries = reg.counter(
            "m2kt_router_retries_total", "Requests retried on another "
            "replica after a failure")
        self._retry_reasons = reg.counter(
            "m2kt_router_retries_by_reason_total",
            "Retries by the failure reason that triggered them",
            labels=("reason",))
        self._markdowns = reg.counter(
            "m2kt_router_marked_down_total",
            "Replicas marked down, by replica and failure reason",
            labels=("replica", "reason"))
        self._hedges = reg.counter(
            "m2kt_router_hedges_total", "Duplicate requests fired at the "
            "runner-up after the hedge deadline")
        self._affinity_hits = reg.counter(
            "m2kt_router_affinity_hits_total",
            "Requests routed to their prefix-affine replica")
        self._spills = reg.counter(
            "m2kt_router_spills_total",
            "Requests spilled to the least-loaded replica (affine replica "
            "down or queue too deep)")
        self._replica_up = reg.gauge(
            "m2kt_router_replica_up", "1 if the replica passed its last "
            "health check", labels=("replica",))
        self._replica_queue = reg.gauge(
            "m2kt_router_replica_queue_depth",
            "Queued + active requests on the replica at last poll",
            labels=("replica",))
        self._inflight = reg.gauge(
            "m2kt_router_inflight", "Requests currently being routed")
        self._disagg = reg.counter(
            "m2kt_router_disagg_total",
            "Requests served via prefill->decode handoff")
        self._swaps = reg.counter(
            "m2kt_router_swap_total",
            "Live weight-swap fan-out, by per-replica outcome",
            labels=("outcome",))
        # demand attribution in TOKENS, not requests: prompt + max_new
        # estimated at admission (the forecaster needs the demand the
        # moment it is admitted, not after generation finishes), then
        # corrected at completion — over-estimates land in the paired
        # unused counter because a Prometheus counter cannot go down.
        # Net demand = admitted - unused (admitted_tokens()).
        tenant_cap = max_tenants() + 1
        self._admitted_tokens = reg.counter(
            "m2kt_router_admitted_tokens_total",
            "Admitted demand in tokens by tenant (prompt + max_new at "
            "admission, under-estimates topped up at completion)",
            labels=("tenant",), max_series=tenant_cap)
        self._admitted_unused = reg.counter(
            "m2kt_router_admitted_tokens_unused_total",
            "Admission-estimate tokens the completion did not use "
            "(early EOS / shed) — subtract from admitted for net demand",
            labels=("tenant",), max_series=tenant_cap)
        # optional pull source for POST /swap with no inline tree:
        # a callable returning (variables, version)
        self.weight_source = None
        for r in self.replicas:
            self._replica_up.labels(replica=r.name).set(1.0)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _probe_delay(self, name: str, fails: int) -> float:
        """Exponential backoff with deterministic jitter for readmission
        probes: base * 2^(fails-1), capped, +0..50% jitter hashed from
        (replica, fails) — every router instance spreads its probes the
        same way without sharing a clock or an RNG."""
        base = self.config.probe_backoff_base_s
        cap = self.config.probe_backoff_cap_s
        delay = min(cap, base * (2 ** max(0, fails - 1)))
        jitter = (_rendezvous_score(fails, name) % 1000) / 2000.0
        return delay * (1.0 + jitter)

    def probe(self) -> dict:
        """Poll replica health endpoints and refresh the up/queue gauges.
        Recovered replicas rejoin the affinity ring here. A replica whose
        last probe FAILED is skipped until its backoff lapses, so a fleet
        of routers does not thundering-herd a replica that just
        restarted; a freshly marked-down replica (no failed probe yet) is
        still probed immediately."""
        now = time.monotonic()
        out = {}
        for r in self.replicas:
            fails, next_ts = self._probe_state.get(r.name, (0, 0.0))
            if fails and now < next_ts:
                out[r.name] = self._up.get(r.name, False)
                continue
            up = bool(r.healthy())
            self._up[r.name] = up
            self._replica_up.labels(replica=r.name).set(1.0 if up else 0.0)
            if up:
                self._probe_state.pop(r.name, None)
                self._replica_queue.labels(replica=r.name).set(
                    r.queue_depth())
            else:
                fails += 1
                self._probe_state[r.name] = (
                    fails, now + self._probe_delay(r.name, fails))
            out[r.name] = up
        return out

    def _healthy(self):
        return [r for r in self.replicas if self._up.get(r.name, True)]

    def pick(self, prompt, exclude=()) -> ReplicaHandle | None:
        """Affine replica by rendezvous hash of the prompt prefix,
        spilling to least-loaded when it is excluded, down, or
        backlogged. Pure placement — no side effects beyond metrics."""
        excluded = {r.name for r in exclude}
        healthy = [r for r in self._healthy() if r.name not in excluded]
        if not healthy:
            return None
        key = prefix_hash(prompt, self.config.salt,
                          self.config.affinity_tokens)
        affine = max(healthy,
                     key=lambda r: _rendezvous_score(key, r.name))
        if affine.queue_depth() <= self.config.spill_queue_depth:
            self._affinity_hits.inc()
            return affine
        self._spills.inc()
        return min(healthy, key=lambda r: r.queue_depth())

    def _mark_down(self, replica: ReplicaHandle,
                   reason: str = "probe") -> None:
        self._up[replica.name] = False
        self._replica_up.labels(replica=replica.name).set(0.0)
        self._markdowns.labels(replica=replica.name, reason=reason).inc()

    # ------------------------------------------------------------------
    # weight plane
    # ------------------------------------------------------------------

    def swap(self, variables=None, version: int | None = None) -> dict:
        """Roll a live weight swap across the fleet, one replica at a
        time — the in-process analogue of a PDB-respecting rolling
        update: at most one replica is ever inside its swap, every
        other replica keeps serving, and unhealthy replicas are skipped
        (they re-pull on readmission). A replica that dies mid-swap
        (chaos ``M2KT_CHAOS_SWAP=kill``) is marked down and the roll
        continues — its in-flight streams resume on survivors via the
        journal, so a swap under chaos drops zero requests."""
        if variables is None and self.weight_source is not None:
            variables, version = self.weight_source()
        swapped = failed = skipped = 0
        installed = None
        for replica in list(self.replicas):
            if not self._up.get(replica.name, True):
                skipped += 1
                self._swaps.labels(outcome="skipped").inc()
                continue
            try:
                installed = replica.swap(variables, version)
                if version is None:
                    # first success pins the generation the rest of the
                    # roll installs, so the fleet converges on one number
                    version = installed
                swapped += 1
                self._swaps.labels(outcome="ok").inc()
            except Exception as err:  # noqa: BLE001 - keep rolling
                self._mark_down(replica, failure_reason(err))
                failed += 1
                self._swaps.labels(outcome="failed").inc()
        return {"weights_version": installed, "swapped": swapped,
                "failed": failed, "skipped": skipped}

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------

    def _open_call(self, root, replica: ReplicaHandle, hop: str):
        """Open a ``router.call`` child span for one replica hop and
        return ``(span, traceparent_header)`` — the header is what rides
        the outbound request so the replica's root parents under it."""
        if self.tracer is None or root is None:
            return None, ""
        span = self.tracer.start(
            "router.call",
            attrs={"replica": getattr(replica, "name", hop), "hop": hop},
            parent=root, detached=True)
        return span, span.traceparent()

    def admitted_tokens(self) -> float:
        """Net admitted token demand across every tenant: the admission
        estimates minus the completion corrections. Monotone except for
        the moment a correction lands, which a windowed rate absorbs —
        this is the counter the demand forecaster differences."""
        return (self._admitted_tokens.total()
                - self._admitted_unused.total())

    def generate(self, prompt, max_new_tokens: int | None = None,
                 rid: str | None = None, tenant: str = "",
                 traceparent: str | None = None,
                 deadline_s: float | None = None,
                 adapter: str = "") -> dict:
        prompt = list(prompt)
        tenant = clean_tenant(tenant)
        # admission runs before any placement or span work: an
        # over-quota tenant costs the fleet nothing but this check
        # (the HTTP front maps SchedThrottled to 429)
        try:
            self.admission.admit(tenant)
        except SchedThrottled:
            self._requests.labels(outcome="throttled").inc()
            raise
        # token-demand attribution at admission: the forecaster reads
        # this rate, so it must move when demand ARRIVES, not when the
        # decode finishes minutes later
        est_tokens = len(prompt) + int(
            max_new_tokens or EngineConfig.max_new_tokens)
        self._admitted_tokens.labels(tenant=tenant).inc(est_tokens)
        self._inflight.inc()
        # ONE absolute deadline per request (caller's X-M2KT-Deadline
        # remainder, else the configured default): the disagg attempt,
        # its direct-path fallback, and every resume hop all spend from
        # the same budget
        budget = deadline_s if deadline_s is not None \
            else self.config.deadline_s
        deadline = (time.perf_counter() + budget
                    if budget and budget > 0 else None)
        root = None
        if self.tracer is not None:
            # many requests route concurrently in one process: the root
            # is detached and identity threads through explicitly. An
            # inbound traceparent (a client already tracing) wins.
            root = self.tracer.start(
                "router.request",
                attrs={"prompt_len": len(prompt), "tenant": tenant},
                detached=True, remote_parent=traceparent)
        try:
            out = None
            if (self.config.disagg_threshold
                    and len(prompt) >= self.config.disagg_threshold
                    and self.prefill_replicas):
                try:
                    out = self._generate_disagg(prompt, max_new_tokens,
                                                rid, tenant, root,
                                                deadline)
                except DeadlineExceeded:
                    raise  # no budget left for the direct fallback either
                except Exception:  # noqa: BLE001 - fall back to direct path
                    out = None
            if out is None:
                out = self._generate_direct(prompt, max_new_tokens, rid,
                                            tenant, root, deadline,
                                            adapter=adapter)
            # completion correction: top up an under-estimate, park an
            # over-estimate (early EOS) in the unused counter
            actual = len(prompt) + len(out.get("tokens", ()))
            if actual > est_tokens:
                self._admitted_tokens.labels(tenant=tenant).inc(
                    actual - est_tokens)
            elif actual < est_tokens:
                self._admitted_unused.labels(tenant=tenant).inc(
                    est_tokens - actual)
            self._requests.labels(outcome="ok").inc()
            return out
        except Exception as err:
            self._requests.labels(outcome="error").inc()
            if root is not None:
                root.attrs["error"] = failure_reason(err)
            raise
        finally:
            if root is not None:
                self.tracer.end(root)
            self._inflight.dec()

    @staticmethod
    def _remaining(deadline: float | None) -> float | None:
        return (deadline - time.perf_counter()
                if deadline is not None else None)

    def _generate_direct(self, prompt, max_new_tokens, rid, tenant="",
                         root=None, deadline: float | None = None,
                         adapter: str = "") -> dict:
        tried: list[ReplicaHandle] = []
        last_err: Exception | None = None
        # the journal: every token any replica has emitted for this
        # request, in order, fed by the engine's on_token hook. On a
        # mid-stream death it is what makes the retry a RESUME — the
        # journaled tokens ride the next attempt as a forced prompt
        # suffix, and greedy decode regenerates the rest byte-identically
        emitted: list[int] = []
        max_new = max_new_tokens or EngineConfig.max_new_tokens
        attempt = preempts = 0
        while attempt <= self.config.max_retries:
            journal = list(emitted)
            resumed = bool((attempt or preempts) and journal)
            if journal and (len(journal) >= max_new
                            or (self.config.eos_id is not None
                                and journal[-1] == self.config.eos_id)):
                # the dead replica had already emitted the final token;
                # nothing left to decode — complete locally
                reason = (failure_reason(last_err)
                          if last_err is not None else "complete")
                self._resumed.labels(reason=reason).inc()
                return {"rid": rid, "replica": tried[-1].name if tried
                        else "", "prompt_len": len(prompt),
                        "tokens": journal, "resumed": True,
                        "finish_reason": "length"
                        if len(journal) >= max_new else "eos"}
            remaining = self._remaining(deadline)
            if remaining is not None and remaining <= 0:
                if last_err is None:
                    last_err = DeadlineExceeded(
                        f"{rid or 'request'}: deadline spent at the router")
                break
            replica = self.pick(prompt, exclude=tried)
            if replica is None:
                break
            if attempt:
                self._retries.inc()
                if last_err is not None:
                    self._retry_reasons.labels(
                        failure_reason(last_err)).inc()
            if resumed:
                self._resumed.labels(reason=failure_reason(last_err)
                                     if last_err is not None
                                     else "unknown").inc()
                if isinstance(last_err, RequestPreempted):
                    self._sched_resumed.labels(reason="preempted").inc()
            tried.append(replica)
            try:
                if self.config.hedge_after_s is not None:
                    out = self._call_hedged(
                        replica, prompt + journal, max_new - len(journal),
                        rid, tried, tenant, root, remaining,
                        adapter=adapter)
                else:
                    out = self._call_one(
                        replica, prompt + journal, max_new - len(journal),
                        rid, tenant, root, remaining,
                        on_token=emitted.append,
                        hop="resume" if resumed else "generate",
                        adapter=adapter)
                if journal:
                    out = dict(out)
                    out["tokens"] = journal + list(out["tokens"])
                    out["prompt_len"] = len(prompt)
                    out["resumed"] = True
                return out
            except DeadlineExceeded:
                raise  # the caller's problem; not the replica's fault
            except RequestPreempted as err:
                # paused, not failed: the replica stays up AND stays
                # eligible — the same engine usually resumes the work
                # once the higher-priority burst passes. Bounded so a
                # best-effort request cannot spin forever under flood.
                last_err = err
                tried.pop()
                preempts += 1
                if preempts > self.config.max_preempt_resumes:
                    break
            except Exception as err:  # noqa: BLE001 - any failure fails over
                last_err = err
                self._mark_down(replica, failure_reason(err))
                attempt += 1
        if last_err is not None:
            raise last_err
        raise RuntimeError("router: no healthy replica available")

    def _call_one(self, replica, prompt, max_new_tokens, rid, tenant,
                  root, deadline_s: float | None = None, on_token=None,
                  hop: str = "generate", adapter: str = "") -> dict:
        span, header = self._open_call(root, replica, hop)
        # adapter rides only when set, so pre-sched ReplicaHandle
        # subclasses keep their narrower generate() signature
        extra = {"adapter": adapter} if adapter else {}
        try:
            return replica.generate(prompt, max_new_tokens, rid,
                                    tenant=tenant, traceparent=header,
                                    deadline_s=deadline_s,
                                    on_token=on_token, **extra)
        except Exception as err:  # noqa: BLE001 - annotate, then re-raise
            if span is not None:
                span.attrs["error"] = failure_reason(err)
            raise
        finally:
            if span is not None:
                self.tracer.end(span)

    def _call_hedged(self, primary, prompt, max_new_tokens, rid,
                     tried, tenant="", root=None,
                     deadline_s: float | None = None,
                     adapter: str = "") -> dict:
        """Fire ``primary``; if it has not answered within the hedge
        deadline, fire the runner-up too and take whichever finishes
        first. The loser's work is wasted by design — hedging trades
        duplicate decode for tail latency."""
        done = threading.Event()
        results: list[dict] = []
        errors: list[Exception] = []

        def call(replica):
            try:
                # hedges carry no journal feed: two replicas racing one
                # request would interleave a single journal — hedging is
                # its own redundancy, so the loser is simply discarded
                results.append(self._call_one(
                    replica, prompt, max_new_tokens, rid, tenant, root,
                    deadline_s, adapter=adapter))
                done.set()
            except Exception as err:  # noqa: BLE001 - collected below
                errors.append(err)
                if len(errors) >= len(threads):
                    done.set()

        threads = [threading.Thread(target=call, args=(primary,),
                                    daemon=True)]
        threads[0].start()
        if not done.wait(self.config.hedge_after_s):
            backup = self.pick(prompt, exclude=tried)
            if backup is not None:
                self._hedges.inc()
                tried.append(backup)
                threads.append(threading.Thread(target=call, args=(backup,),
                                                daemon=True))
                threads[1].start()
        done.wait()
        while not results and any(t.is_alive() for t in threads):
            time.sleep(0.005)
        if results:
            return results[0]
        raise errors[0] if errors else RuntimeError("hedge: no result")

    def _generate_disagg(self, prompt, max_new_tokens, rid, tenant="",
                         root=None, deadline: float | None = None) -> dict:
        """Long prompts route prefill->decode: round-robin a prefill
        replica for the KV handoff, then seat it on the prefix-affine
        decode replica (same placement as the direct path, so the
        decode side's cache locality is preserved). Both hops get their
        own router.call span; the handoff wire carries the install
        hop's traceparent so the decode replica's root stitches under
        it even when the bytes travel through a queue. Both hops spend
        from the request's one deadline budget."""
        prefill = self.prefill_replicas[self._rr
                                        % len(self.prefill_replicas)]
        self._rr += 1
        pspan, pheader = self._open_call(root, prefill, "prefill")
        try:
            handoff = prefill.prefill(Request(
                rid=rid or f"disagg-{self._rr}", prompt=list(prompt),
                max_new_tokens=max_new_tokens, tenant=tenant,
                traceparent=pheader,
                deadline_s=self._remaining(deadline)))
        finally:
            if pspan is not None:
                self.tracer.end(pspan)
        decode = self.pick(prompt)
        if decode is None:
            raise RuntimeError("router: no healthy decode replica")
        dspan, dheader = self._open_call(root, decode, "install")
        handoff.tenant = tenant
        handoff.traceparent = dheader
        try:
            out = decode.install(handoff.to_bytes(), tenant=tenant,
                                 traceparent=dheader,
                                 deadline_s=self._remaining(deadline))
        finally:
            if dspan is not None:
                self.tracer.end(dspan)
        self._disagg.inc()
        return out


class RouterHTTPServer:
    """stdlib-HTTP front for the router role. ``/readyz`` reports
    serving once any backend replica is healthy, so the router pod's
    readiness gate composes with the engines' own gates."""

    def __init__(self, router: Router, port: int = 8000,
                 default_max_new: int | None = None):
        self.router = router
        self.default_max_new = default_max_new
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, b'{"status":"ok"}')
                elif self.path == "/readyz":
                    up = outer.router.probe()
                    ready = any(up.values())
                    body = json.dumps({"ready": ready,
                                       "replicas": up}).encode()
                    self._send(200 if ready else 503, body)
                elif self.path == "/metrics":
                    self._send(200, outer.router.registry.render().encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._send(404, b'{"error":"not found"}')

            def do_POST(self):
                if self.path == "/swap":
                    # fan a rolling live weight swap across the fleet;
                    # the body may pin the generation number
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        doc = json.loads(self.rfile.read(n) or b"{}")
                        raw = doc.get("version")
                        out = outer.router.swap(
                            version=int(raw) if raw is not None else None)
                        code = 200 if out["swapped"] else 503
                        self._send(code, json.dumps(out).encode())
                    except Exception as err:  # noqa: BLE001
                        self._send(500, json.dumps(
                            {"error": str(err)}).encode())
                    return
                if self.path != "/generate":
                    self._send(404, b'{"error":"not found"}')
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n).decode())
                    raw_deadline = self.headers.get(DEADLINE_HEADER)
                    deadline_s = (float(raw_deadline)
                                  if raw_deadline else None)
                    out = outer.router.generate(
                        payload["prompt"],
                        payload.get("max_new_tokens",
                                    outer.default_max_new),
                        payload.get("rid"),
                        tenant=self.headers.get(TENANT_HEADER, ""),
                        traceparent=self.headers.get(
                            TRACEPARENT_HEADER),
                        deadline_s=deadline_s,
                        adapter=payload.get("adapter", "") or "")
                    self._send(200, json.dumps(out).encode())
                except SchedThrottled as err:
                    self._send(429, json.dumps(
                        {"error": str(err)}).encode())
                except DeadlineExceeded as err:
                    self._send(504, json.dumps(
                        {"error": str(err)}).encode())
                except Exception as err:  # noqa: BLE001 - surface as 500
                    self._send(500, json.dumps(
                        {"error": str(err)}).encode())

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="m2kt-router",
            daemon=True)

    def start(self) -> "RouterHTTPServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def build_fleet(model, n_replicas: int,
                engine_config: EngineConfig | None = None,
                router_config: RouterConfig | None = None,
                registry: Registry | None = None, *,
                device=None) -> Router:
    """An in-process fleet: N engine replicas of ``model`` behind a
    router, each engine on ``device`` (the card by default) with its own
    KV cache and step thread. The engines share the model's weights (a
    live swap rebinds one engine's modules and leaves the others');
    under a weight-quantizing policy each makes its own int8 copy. Long
    prompts route through prefill replicas appended to
    ``router.prefill_replicas``."""
    cfg = engine_config or EngineConfig.from_env()
    replicas = [
        InProcessReplica(f"replica-{i}",
                         ServingEngine(model, cfg, device=device)).start()
        for i in range(n_replicas)]
    return Router(replicas, config=router_config, registry=registry)
