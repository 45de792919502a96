#!/usr/bin/env python
"""One-GPU serving program generated by move2kube-tpu (cuda emitter).

The workload this program replaces and its model family are baked into
the constants below (``SOURCE_ENTRYPOINT``, ``FAMILY``).

Continuous-batching decode server over the vendored
``move2kube_tpu_torch`` serving engine (the package directory alongside
this file): paged KV cache, bucketed prefill, the flash and paged-decode
attention in hand-written CUDA kernels. Requests join and leave the batch
mid-flight — no generation waits for the longest prompt in a static
batch. It runs on the card unless ``M2KT_DEVICE=cpu``; with no card and
no such knob it exits non-zero rather than moving to the CPU.

HTTP API (stdlib server, no web-framework dependency):

    POST /generate   {"prompt": [token ids], "max_new_tokens": 32}
                  -> {"tokens": [...], "finish_reason": "eos"|"length"}
                  add "stream": true -> text/event-stream, one
                  data: {"token": id} event per committed token,
                  terminal data: {"finish_reason": ...}
    POST /install    (fleet decode role) serialized KV handoff bytes
                  -> same completion doc as /generate
    POST /swap       live weight swap between decode steps
    POST /drain   -> graceful drain: stop admitting, finish in-flight
                  work within M2KT_DRAIN_GRACE_S, flip /readyz (SIGTERM
                  runs the same path, then stops the listener)
    GET  /healthz -> 200 once the engine is warm
    GET  /stats   -> decode throughput / latency percentiles and the
                  model passes by kind, of the traffic since the engine
                  went ready (the warm request reaches no record: not
                  these, not /metrics, not the SLO ledger); ``warm``:
                  the warm request's own counters, a record;
                  ``launches``: each attention kernel's launches since
                  the engine went ready

``M2KT_SERVE_PORT=0`` binds a free port; the ``[m2kt] serving on :PORT``
line names the bound one (and ``[m2kt] telemetry on :PORT`` the metrics
listener's).

Deadlines: the X-M2KT-Deadline header (remaining seconds, set by the
router) rides into the engine, which sheds unmeetable requests at
admission (HTTP 504 here) instead of timing them out slowly.

Fleet mode (M2KT_FLEET_ROLE): ``router`` runs the prefix-affine request
router over the backend pods of M2KT_ROUTER_BACKENDS; ``prefill`` serves
POST /prefill returning KV handoff bytes for disaggregated long prompts;
``autoscaler`` runs the predictive scaling controller; ``decode`` (and
the default, single-pod mode) is the engine server above.

``M2KT_ASYNC_DECODE`` (auto | on | off; auto runs the engine's async
decode pipeline whenever spec decode is off) and
``M2KT_DECODE_SUBSTEPS`` (decode passes a dispatched window) go to the
engine as the JAX program passes them. ``M2KT_SERVE_KERNELS`` is decided
here with one printed line: ``auto``/``on`` are the hand-written
kernels, the port's only mode on a card; ``off`` asks for a plain path
the port does not have, and exits 2.

Swap the tokenizer-free token-id API for your real pre/post-processing;
the engine interface (serving/engine.py) is the stable surface.
"""

import json
import os
import queue
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from move2kube_tpu_torch import obs as m2kt_obs
from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.compile_cache import setup_compilation_cache
from move2kube_tpu_torch.ops.attention import KERNELS, reset_launch_counts
from move2kube_tpu_torch.resilience.faults import serving_chaos
from move2kube_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineConfig,
    EngineDraining,
    Request,
    ServingEngine,
)
from move2kube_tpu_torch.serving.fleet import weights as m2kt_weights
from move2kube_tpu_torch.serving.fleet.chaos import ChaosKill
from move2kube_tpu_torch.serving.fleet.router import DEADLINE_HEADER, TokenFanout

# m2kt:baked-begin (the emitter rewrites these lines)
SOURCE_ENTRYPOINT = "(unknown)"
FAMILY = "llama"
SERVE_PORT_DEFAULT = 8080
SERVE_MAX_BATCH_DEFAULT = 8
SERVE_MAX_SEQ_DEFAULT = 2048
SERVE_KV_BLOCK_DEFAULT = 16
SERVE_QUANT_DEFAULT = "off"
SERVE_KERNELS_DEFAULT = "auto"
SPEC_K_DEFAULT = 0
SERVE_ASYNC_DEFAULT = "auto"
SERVE_SUBSTEPS_DEFAULT = 1
SLO_TTFT_P95 = 0.5
SLO_AVAILABILITY = 0.99
SLO_MAX_TENANTS = 8
SCHED_PRIORITIES = ""
SCHED_QUOTAS = ""
SCHED_CHUNK_PREFILL = 0
SCHED_MAX_LORAS = 0
AUTOSCALE_INTERVAL = 15
NUMERICS = "1"
QUANT_AUDIT_RATE = "0"
COMPILE_CACHE_DIR = "/app/.m2kt-cache"
METRICS_PORT_DEFAULT = 9090
WEIGHTS_PORT_DEFAULT = 8981
# m2kt:baked-end

PORT = int(os.environ.get("M2KT_SERVE_PORT", str(SERVE_PORT_DEFAULT)))
MAX_BATCH = int(os.environ.get("M2KT_SERVE_MAX_BATCH",
                               str(SERVE_MAX_BATCH_DEFAULT)))
MAX_SEQ = int(os.environ.get("M2KT_SERVE_MAX_SEQ", str(SERVE_MAX_SEQ_DEFAULT)))
KV_BLOCK = int(os.environ.get("M2KT_KV_BLOCK_SIZE",
                              str(SERVE_KV_BLOCK_DEFAULT)))
# low-precision serving policy (off | int8 | int8-kv) and speculative-
# decoding proposal length (0 = off): baked defaults, env wins
SERVE_QUANT = (os.environ.get("M2KT_SERVE_QUANT", "")
               or SERVE_QUANT_DEFAULT).strip().lower()
if SERVE_QUANT not in ("off", "int8", "int8-kv"):
    print(f"[m2kt] WARNING: unknown M2KT_SERVE_QUANT {SERVE_QUANT!r}; "
          "serving full precision", flush=True)
    SERVE_QUANT = "off"
SPEC_K = max(0, int(os.environ.get("M2KT_SPEC_K", "") or SPEC_K_DEFAULT))
ASYNC_DECODE = (os.environ.get("M2KT_ASYNC_DECODE", "")
                or SERVE_ASYNC_DEFAULT).strip().lower()
if ASYNC_DECODE not in ("auto", "on", "off"):
    print(f"[m2kt] WARNING: unknown M2KT_ASYNC_DECODE {ASYNC_DECODE!r}; "
          "using auto", flush=True)
    ASYNC_DECODE = "auto"
DECODE_SUBSTEPS = max(1, int(os.environ.get("M2KT_DECODE_SUBSTEPS", "")
                             or SERVE_SUBSTEPS_DEFAULT))
SERVE_KERNELS = (os.environ.get("M2KT_SERVE_KERNELS", "")
                 or SERVE_KERNELS_DEFAULT).strip().lower()
if SERVE_KERNELS not in ("auto", "on", "off"):
    print(f"[m2kt] WARNING: unknown M2KT_SERVE_KERNELS {SERVE_KERNELS!r}; "
          "using auto", flush=True)
    SERVE_KERNELS = "auto"
# telemetry plane on its own port: /metrics with TTFT + per-token latency
# histograms, queue depth, page-pool utilization; /profile for on-demand
# torch.profiler captures. Env wins over the baked default; 0 disables.
METRICS_PORT = int(os.environ.get("M2KT_METRICS_PORT",
                                  str(METRICS_PORT_DEFAULT)))
# weight plane (serving/fleet/weights.py): joining replicas stream the
# parameter shards from their serving peers here instead of re-reading
# the checkpoint store; 0 disables peer serving (fetching still follows
# M2KT_WEIGHTS_PEERS)
WEIGHTS_PORT = int(os.environ.get("M2KT_WEIGHTS_PORT",
                                  str(WEIGHTS_PORT_DEFAULT)))
FLEET_ROLE = os.environ.get("M2KT_FLEET_ROLE", "").strip().lower()
# per-tenant SLO plane, numerics plane, scheduler plane and the
# autoscaler's loop period: baked defaults, env wins (setdefault)
for _key, _value in (
        ("M2KT_SLO_TTFT_P95_S", SLO_TTFT_P95),
        ("M2KT_SLO_AVAILABILITY", SLO_AVAILABILITY),
        ("M2KT_OBS_MAX_TENANTS", SLO_MAX_TENANTS),
        ("M2KT_NUMERICS", NUMERICS),
        ("M2KT_QUANT_AUDIT_RATE", QUANT_AUDIT_RATE),
        ("M2KT_SCHED_PRIORITIES", SCHED_PRIORITIES),
        ("M2KT_SCHED_QUOTAS", SCHED_QUOTAS),
        ("M2KT_SCHED_CHUNK_PREFILL", SCHED_CHUNK_PREFILL),
        ("M2KT_SCHED_MAX_LORAS", SCHED_MAX_LORAS),
        ("M2KT_AUTOSCALE_INTERVAL_S", AUTOSCALE_INTERVAL)):
    os.environ.setdefault(_key, str(_value))


def decide_engine_knobs() -> None:
    """The knob the port's engine does not read, decided with one printed
    line; the mode the port lacks exits 2."""
    if SERVE_KERNELS == "off":
        print("[m2kt] M2KT_SERVE_KERNELS=off: the port has no plain "
              "attention path on a card; its attention is the hand-written"
              " kernels", flush=True)
        raise SystemExit(2)
    print(f"[m2kt] M2KT_SERVE_KERNELS={SERVE_KERNELS}: the hand-written "
          "flash and paged-decode kernels", flush=True)


def device():
    return resolve_device(os.environ.get("M2KT_DEVICE") or None)


def build_model(dev):
    """The baked family's model with weights drawn on ``dev`` from seed 0
    (the store or a peer replaces them in ``_acquire_weights``)."""
    from move2kube_tpu_torch.models import convert as m2kt_convert

    if FAMILY == "gpt2":
        from move2kube_tpu_torch.models.gpt2 import GPT2Config

        cfg = GPT2Config(
            vocab_size=int(os.environ.get("M2KT_VOCAB", "50257")),
            n_positions=max(MAX_SEQ, 1024),
            d_model=int(os.environ.get("M2KT_DMODEL", "768")),
            num_layers=int(os.environ.get("M2KT_LAYERS", "12")),
            num_heads=int(os.environ.get("M2KT_HEADS", "12")))
        return m2kt_convert.init_gpt2(cfg, seed=0, device=dev).eval(), cfg
    from move2kube_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(
        vocab_size=int(os.environ.get("M2KT_VOCAB", "32000")),
        d_model=int(os.environ.get("M2KT_DMODEL", "4096")),
        num_layers=int(os.environ.get("M2KT_LAYERS", "32")),
        num_heads=int(os.environ.get("M2KT_HEADS", "32")),
        num_kv_heads=int(os.environ.get("M2KT_KV_HEADS", "8")),
        mlp_dim=int(os.environ.get("M2KT_MLP_DIM", "14336")),
        max_len=MAX_SEQ, attn_impl="flash")
    return m2kt_convert.init_llama(cfg, seed=0, device=dev).eval(), cfg


def _acquire_weights(variables, want_version=None):
    """Weight plane, fetch side: peers first (M2KT_WEIGHTS_PEERS — the
    streamed P2P fan-out), checkpoint store second (M2KT_CKPT_DIR), the
    caller's fresh init last. ``variables`` is the model's state dict (it
    gives each array's name, shape, dtype and device). Returns
    ``(variables, version, source)`` with source in ``peer|store|init``;
    every outcome lands in ``m2kt_weights_fetch_total``."""
    registry = m2kt_obs.default_registry()
    fetches = m2kt_weights.weights_fetch_counter(registry)
    peers = m2kt_weights.peers_from_env()
    if peers:
        got = m2kt_weights.fetch_from_peers(peers, registry=registry,
                                            want_version=want_version)
        if got is not None:
            fetched, version = got
            print(f"[m2kt] weights v{version} streamed from peers "
                  f"({len(peers)} candidate(s))", flush=True)
            return fetched, version, "peer"
        fetches.labels(source="store", reason="fallback").inc()
        print("[m2kt] peer weight fetch failed; falling back to the "
              "checkpoint store", flush=True)
    ckpt = os.environ.get("M2KT_CKPT_DIR", "")
    if ckpt:
        from move2kube_tpu_torch.models import checkpoint as m2kt_ckpt

        variables = m2kt_ckpt.restore_variables(ckpt, variables)
        fetches.labels(source="store", reason="ok").inc()
        return variables, want_version, "store"
    return variables, want_version, "init"


def _stand_ins(state_dict) -> dict:
    """One-element stand-ins with each array's shape, dtype and device: the
    base a swap-time store restore reads its names and types from, without
    keeping a second copy of the weights alive."""
    return {k: torch.zeros((), dtype=v.dtype, device=v.device).expand(v.shape)
            for k, v in state_dict.items()}


class _Server:
    """Owns the engine. One worker thread steps it; request threads hand
    work over a queue and wait on per-request events — the engine itself
    is single-threaded."""

    def __init__(self, dev) -> None:
        model, cfg = build_model(dev)
        variables, peer_version, source = _acquire_weights(model.state_dict())
        if source != "init":
            model.load_state_dict(variables)
        del variables
        print(f"[m2kt] weights from {source}", flush=True)
        # the engine publishes its metrics (TTFT/latency histograms,
        # admit/reject counters, page-pool gauges) into the registry the
        # telemetry server scrapes
        self.engine = ServingEngine(
            model,
            EngineConfig.from_env(
                max_batch=MAX_BATCH, max_seq=MAX_SEQ, block_size=KV_BLOCK,
                quant=SERVE_QUANT, spec_k=SPEC_K,
                async_decode=ASYNC_DECODE, substeps=DECODE_SUBSTEPS),
            device=dev, registry=m2kt_obs.default_registry())
        if peer_version is not None:
            # a P2P join inherits the fleet's resident weight generation
            self.engine.install_weights(self.engine.model.state_dict(),
                                        peer_version)
        # multi-LoRA registry (M2KT_SCHED_MAX_LORAS > 0): adapters
        # resident at boot load from a directory of <name>.npz files
        lora_dir = os.environ.get("M2KT_LORA_DIR", "").strip()
        if lora_dir and self.engine.adapters is not None:
            count = self.engine.adapters.load_dir(lora_dir)
            print(f"[m2kt] {count} LoRA adapter(s) loaded from "
                  f"{lora_dir}", flush=True)
        # serving side of the weight plane (the snapshot peers stream),
        # only when peers can reach it: it holds a host copy of the
        # weights; re-installed after every live swap
        self.weight_plane = None
        if WEIGHTS_PORT > 0:
            self.weight_plane = m2kt_weights.WeightPlane(
                self.engine.model.state_dict(), self.engine.weights_version)
        self._abstract = _stand_ins(model.state_dict())
        del model
        self._pending: queue.Queue = queue.Queue()
        self._installs: queue.Queue = queue.Queue()
        self._swaps: queue.Queue = queue.Queue()
        self._done: dict[str, object] = {}
        self._events: dict[str, threading.Event] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self.ready = threading.Event()
        self.warm_stats: dict = {}
        # serving chaos injectors (M2KT_CHAOS_*, inert in production)
        self.chaos = serving_chaos()
        if self.chaos is not None:
            print("[m2kt] serving chaos armed", flush=True)
        # streaming fan-out: the engine's step thread publishes with one
        # non-blocking put; a worker thread feeds SSE subscribers
        self.fanout = TokenFanout(registry=m2kt_obs.default_registry())
        role = os.environ.get("M2KT_FLEET_ROLE", "decode") or "decode"

        def _on_token(rid, tok):
            if self.chaos is not None:
                self.chaos.on_token(role, rid, tok)
            self.fanout.publish(rid, tok)

        self.engine.on_token = _on_token
        self._stopping = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the step loop and wait for it: no thread runs the engine
        while the interpreter shuts down."""
        self._stopping.set()
        self._thread.join(timeout)

    def _finish(self, rid: str, outcome) -> None:
        """Hand a completion (or the error that replaced it) to the
        waiting request thread, tolerating a waiter that already gave
        up on its deadline."""
        ev = self._events.pop(rid, None)
        if ev is not None:
            self._done[rid] = outcome
            ev.set()
        # terminal stream event — on errors too, so an SSE consumer
        # never hangs on an admission refusal
        self.fanout.finish(
            rid, getattr(outcome, "finish_reason", None) or "error")

    def _loop(self) -> None:
        # warm the kernels before accepting traffic: one single-token
        # request walks prefill (smallest bucket) + decode, recorded
        # nowhere a user reads (its TTFT holds the kernels' load)
        self.warm_stats = self.engine.warm(prompt=[1], max_new_tokens=2)
        print(f"[m2kt] engine warm: passes "
              f"{json.dumps(self.warm_stats['passes'])}", flush=True)
        # roofline/MFU cost model of every bucketed pass: sets the
        # m2kt_serve_* cost gauges and arms the OOM flight sidecar. Runs
        # once, before traffic is admitted.
        try:
            # the card's name picks the cost model's chip row
            cost = self.engine.cost_report()
            m2kt_obs.install_memory_snapshot()
            decode = cost.get("decode", {})
            print(f"[m2kt] costmodel: decode "
                  f"flops={decode.get('flops')} "
                  f"roofline={decode.get('roofline')} "
                  f"peak_hbm={decode.get('peak_hbm_bytes')}", flush=True)
        except Exception as e:  # noqa: BLE001 - accounting is advisory
            print(f"[m2kt] costmodel failed: {e}", flush=True)
        # /stats' launch counts cover the traffic from here on
        reset_launch_counts()
        self.ready.set()
        while not self._stopping.is_set():
            # unlike the JAX program, the wait for a request happens only
            # when the engine is idle: a decode step never waits on it
            try:
                req = (self._pending.get_nowait() if self.engine.has_work()
                       else self._pending.get(timeout=0.01))
            except queue.Empty:
                req = None
            if req is not None:
                try:
                    self.engine.submit(req)
                except (DeadlineExceeded, EngineDraining, ValueError) as err:
                    # admission refused: the waiter gets the exception
                    # instead of a completion — never a hang
                    self._finish(req.rid, err)
            # disagg handoffs (fleet decode role): seat prefilled KV;
            # when the engine is full, decode a step and retry
            try:
                h = self._installs.get_nowait()
            except queue.Empty:
                h = None
            if h is not None:
                try:
                    ok, done = self.engine.install_prefilled(
                        h.request(), h.kv, h.first_token, h.prompt_len)
                except (DeadlineExceeded, EngineDraining, ValueError) as err:
                    ok, done = True, []
                    self._finish(h.rid, err)
                for comp in done:
                    self._finish(comp.rid, comp)
                if not ok:
                    self._installs.put(h)
            # live weight swap (POST /swap): runs between decode steps on
            # this thread; in-flight slots keep their pages and continue
            # on the new weights
            try:
                sw = self._swaps.get_nowait()
            except queue.Empty:
                sw = None
            if sw is not None:
                rid, version = sw
                try:
                    self._finish(rid, self._swap_now(version))
                except ChaosKill as err:
                    print(f"[m2kt] FATAL: died mid-swap: {err}",
                          flush=True)
                    os._exit(1)
                except Exception as err:  # noqa: BLE001 - a failed swap
                    # must never take the worker down; the old weights stay
                    self._finish(rid, err)
            if self.engine.has_work():
                try:
                    comps = self.engine.step()
                except Exception as err:  # noqa: BLE001 - injected kill
                    # an engine-step death is a real replica crash: die
                    # hard so the pod restarts and the router resumes
                    # streams on a survivor
                    print(f"[m2kt] FATAL: engine step died: {err}",
                          flush=True)
                    os._exit(1)
                for comp in comps:
                    self._finish(comp.rid, comp)

    def _wait(self, rid: str, ev: threading.Event, deadline_s=None):
        """Wait for a completion box; the deadline is the router's
        propagated remaining-seconds budget — no fixed local timeout."""
        if not ev.wait(timeout=deadline_s):
            self._events.pop(rid, None)
            self._done.pop(rid, None)
            raise DeadlineExceeded(
                f"{rid}: deadline {deadline_s:.3f}s elapsed in flight")
        out = self._done.pop(rid)
        if isinstance(out, Exception):
            raise out
        return out

    def _new_rid(self, prefix: str = "r") -> str:
        with self._lock:
            rid = f"{prefix}{self._next_id}"
            self._next_id += 1
        return rid

    def install(self, handoff_bytes, deadline_s=None):
        """Seat a serialized KV handoff and wait for its completion — the
        fleet decode role's POST /install."""
        from move2kube_tpu_torch.serving.fleet.disagg import KVHandoff

        h = KVHandoff.from_bytes(handoff_bytes)
        if self.engine.draining:
            raise EngineDraining(f"{h.rid}: replica is draining")
        ev = threading.Event()
        self._events[h.rid] = ev
        self._installs.put(h)
        return self._wait(h.rid, ev, deadline_s)

    def generate(self, prompt, max_new_tokens, tenant="", traceparent="",
                 deadline_s=None, adapter=""):
        if self.engine.draining:
            raise EngineDraining("replica is draining")
        rid = self._new_rid()
        ev = threading.Event()
        self._events[rid] = ev
        self._pending.put(
            Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                    tenant=tenant, traceparent=traceparent,
                    deadline_s=deadline_s, adapter=adapter))
        return self._wait(rid, ev, deadline_s)

    def generate_stream(self, prompt, max_new_tokens, tenant="",
                        traceparent="", deadline_s=None, adapter=""):
        """Streaming variant of :meth:`generate`: subscribes to the
        fan-out before submitting (so the head of the stream cannot be
        missed) and returns ``(rid, subscriber_queue)``. The caller
        drains ``("token", id)`` events until the terminal ``finish`` /
        ``lagged``, then calls :meth:`reap`."""
        if self.engine.draining:
            raise EngineDraining("replica is draining")
        rid = self._new_rid()
        sub = self.fanout.subscribe(rid)
        self._events[rid] = threading.Event()
        self._pending.put(
            Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                    tenant=tenant, traceparent=traceparent,
                    deadline_s=deadline_s, adapter=adapter))
        return rid, sub

    def reap(self, rid: str, sub=None) -> None:
        """Discard a streamed request's completion box — its tokens
        already went out over SSE."""
        if sub is not None:
            self.fanout.unsubscribe(rid, sub)
        self._events.pop(rid, None)
        self._done.pop(rid, None)

    def swap(self, version=None, deadline_s=None) -> int:
        """POST /swap: hand a live weight swap to the worker thread and
        wait for the installed generation. Pull-based: this pod
        re-acquires the bytes itself."""
        if self.engine.draining:
            raise EngineDraining("replica is draining")
        rid = self._new_rid("_swap")
        ev = threading.Event()
        self._events[rid] = ev
        self._swaps.put((rid, version))
        return self._wait(rid, ev, deadline_s)

    def _swap_now(self, version) -> int:
        """Worker-thread half of the swap, between decode steps: peers
        already carrying ``version`` stream it P2P; otherwise the
        checkpoint store is re-read."""
        if self.chaos is not None:
            self.chaos.on_swap(
                os.environ.get("M2KT_FLEET_ROLE", "decode") or "decode")
        variables, fetched, source = _acquire_weights(
            self._abstract, want_version=version)
        if source == "init":
            raise ValueError(
                "swap: no weight source — no peer carries the requested "
                "generation and no checkpoint store is configured")
        installed = self.engine.install_weights(
            variables, version if version is not None else fetched)
        if self.weight_plane is not None:
            self.weight_plane.install(self.engine.model.state_dict(),
                                      installed)
        print(f"[m2kt] weights swapped to v{installed} (from {source})",
              flush=True)
        return installed

    def drain(self, grace_s: float) -> bool:
        """Stop admitting, let in-flight requests finish within
        ``grace_s``. True when the engine went idle in time."""
        self.engine.drain()
        deadline = time.monotonic() + max(0.0, grace_s)
        while time.monotonic() < deadline:
            if not self.engine.has_work() and not self._events:
                return True
            time.sleep(0.05)
        return not self.engine.has_work() and not self._events


def _resolve_backends(spec: str, factory):
    """Turn a comma list of ``host:port`` into replica handles, one per
    resolved address — a headless Service name fans out to every pod IP,
    which is what prefix-affine routing needs."""
    import socket

    handles = []
    for entry in [e.strip() for e in spec.split(",") if e.strip()]:
        host, _, port = entry.rpartition(":")
        try:
            infos = socket.getaddrinfo(host, int(port),
                                       type=socket.SOCK_STREAM)
        except OSError:
            infos = []
        addrs = sorted({i[4][0] for i in infos})
        if not addrs:
            handles.append(factory(entry, f"http://{entry}"))
        for addr in addrs:
            handles.append(
                factory(f"{addr}:{port}", f"http://{addr}:{port}"))
    return handles


def _start_weights_server(server) -> None:
    """Serving side of the weight plane: ``GET /weights/manifest`` and
    ``GET /weights/<quoted-path>`` on M2KT_WEIGHTS_PORT. The chaos shard
    injectors ride here, and an injected peer death drops the connection
    without a status line."""
    import urllib.parse

    peer_name = os.environ.get("HOSTNAME", "") or "decode"

    class WeightsHandler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            if not self.path.startswith("/weights/"):
                self._send(404, b'{"error":"not found"}',
                           "application/json")
                return
            tail = urllib.parse.unquote(self.path[len("/weights/"):])
            try:
                if tail == "manifest":
                    data = server.weight_plane.manifest().to_bytes()
                else:
                    data = server.weight_plane.shard_bytes(tail)
                    if server.chaos is not None:
                        data = server.chaos.on_shard(peer_name, tail, data)
            except ValueError as e:
                self._send(404, json.dumps({"error": str(e)}).encode(),
                           "application/json")
                return
            except ChaosKill:
                self.close_connection = True
                return
            self._send(200, data)

    httpd = ThreadingHTTPServer(("", WEIGHTS_PORT), WeightsHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"[m2kt] weight plane on :{httpd.server_address[1]} "
          f"v{server.weight_plane.version}", flush=True)


def run_router() -> None:
    """Fleet router role: no model, no card — the prefix-affine load
    balancer over the decode pods (and prefill pods when disaggregation
    is on), serving /generate /healthz /readyz /metrics on PORT."""
    from move2kube_tpu_torch.serving.fleet.router import (
        HttpReplica, Router, RouterConfig, RouterHTTPServer)

    registry = m2kt_obs.default_registry()
    tracer = (m2kt_obs.get_tracer()
              if m2kt_obs.tracing_enabled() else None)
    telem = None
    if METRICS_PORT > 0:
        # /traces drains the router's span ring for the fleet collector
        telem = m2kt_obs.start_telemetry_server(
            METRICS_PORT, registry=registry, tracer=tracer)

    def replica(name, url):
        return HttpReplica(name, url)

    backends_spec = os.environ.get("M2KT_ROUTER_BACKENDS", "")
    prefill_spec = os.environ.get("M2KT_FLEET_PREFILL_SERVICE", "")
    router = Router(_resolve_backends(backends_spec, replica),
                    config=RouterConfig.from_env(),
                    prefill_replicas=_resolve_backends(prefill_spec,
                                                       replica),
                    registry=registry, tracer=tracer)
    # usage ledger (M2KT_USAGE, default on): the per-tenant net admitted
    # tokens, the allocation basis for fleet chargeback
    if m2kt_obs.usage_enabled():
        ledger = m2kt_obs.UsageLedger(registry=registry)
        ledger.add_source(m2kt_obs.router_source(router), "router")
        ledger.start()
        m2kt_obs.install_usage_flush(ledger)
        if telem is not None:
            telem.set_ledger(ledger)

    def refresh():  # pods come and go under the HPA: re-resolve DNS
        while True:
            time.sleep(float(os.environ.get("M2KT_ROUTER_REFRESH_S", "10")))
            try:
                router.replicas[:] = _resolve_backends(backends_spec,
                                                       replica)
                router.prefill_replicas[:] = _resolve_backends(
                    prefill_spec, replica)
                router.probe()
            except Exception as e:  # noqa: BLE001 - keep refreshing
                print(f"[m2kt] backend refresh failed: {e}", flush=True)

    threading.Thread(target=refresh, daemon=True).start()
    front = RouterHTTPServer(router, port=PORT)
    print(f"[m2kt] fleet router on :{front.port} "
          f"backends={backends_spec or '(none)'} "
          f"prefill={prefill_spec or '(none)'}", flush=True)
    front.start()
    front._thread.join()


def run_autoscaler() -> None:
    """Fleet autoscaler role: no model, no card — the predictive scaling
    controller (serving/fleet/autoscaler.py) polling the router's
    admitted-token counters, exporting the m2kt_autoscale_* gauges on
    METRICS_PORT and, when M2KT_AUTOSCALE_ACTUATE=1, patching the decode
    Deployment's scale subresource."""
    from move2kube_tpu_torch.serving.fleet.autoscaler import run_controller

    registry = m2kt_obs.default_registry()
    if METRICS_PORT > 0:
        telem = m2kt_obs.start_telemetry_server(METRICS_PORT,
                                                registry=registry)
        if telem is not None:
            print(f"[m2kt] telemetry on :{telem.port}", flush=True)
    # usage aggregator (opt-in via M2KT_USAGE_SCRAPE_URLS): scrape every
    # role's /usage ring, refresh the chargeback report and the replay
    # capture on disk
    if m2kt_obs.usage_enabled():
        from move2kube_tpu_torch.serving.fleet.capture import UsageAggregator

        agg = UsageAggregator.from_env(registry=registry)
        if agg is not None:
            agg.start()
            print(f"[m2kt] usage aggregator: {len(agg.urls)} pods -> "
                  f"{agg.out_dir}", flush=True)
    print("[m2kt] fleet autoscaler: url="
          f"{os.environ.get('M2KT_AUTOSCALE_METRICS_URL', '(unset)')} "
          f"target={os.environ.get('M2KT_AUTOSCALE_TARGET', '(unset)')} "
          f"actuate={os.environ.get('M2KT_AUTOSCALE_ACTUATE', '0')}",
          flush=True)
    run_controller(registry=registry)


def run_prefill() -> None:
    """Fleet prefill role: turns prompts into KV handoffs for the decode
    pods. POST /prefill {"prompt": [...]} -> handoff bytes."""
    from move2kube_tpu_torch.serving.fleet.disagg import PrefillReplica

    dev = device()
    setup_compilation_cache(COMPILE_CACHE_DIR)
    registry = m2kt_obs.default_registry()
    model, cfg = build_model(dev)
    variables, _version, source = _acquire_weights(model.state_dict())
    if source != "init":
        model.load_state_dict(variables)
    del variables
    replica = PrefillReplica(
        model,
        EngineConfig.from_env(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                              block_size=KV_BLOCK, quant=SERVE_QUANT),
        device=dev, registry=registry)
    # warm the smallest prefill bucket before taking traffic
    replica.prefill(Request(rid="_warm", prompt=[1]))
    telem = None
    if METRICS_PORT > 0:
        telem = m2kt_obs.start_telemetry_server(
            METRICS_PORT, registry=registry,
            tracer=(m2kt_obs.get_tracer()
                    if m2kt_obs.tracing_enabled() else None))
    if telem is not None:
        telem.set_readiness(lambda: "serving")
    # prefill pods carry no tenant token counters, but they still
    # publish /usage so the aggregator can count their wall-clock
    if m2kt_obs.usage_enabled():
        ledger = m2kt_obs.UsageLedger(registry=registry)
        ledger.start()
        m2kt_obs.install_usage_flush(ledger)
        if telem is not None:
            telem.set_ledger(ledger)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args) -> None:
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            if self.path in ("/healthz", "/readyz"):
                self._send(200, b'{"status":"ok"}')
            else:
                self._send(404, b'{"error":"not found"}')

        def do_POST(self) -> None:  # noqa: N802 (stdlib API)
            if self.path != "/prefill":
                self._send(404, b'{"error":"not found"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                req = Request(
                    rid=str(doc.get("rid") or f"p{time.monotonic_ns()}"),
                    prompt=[int(t) for t in doc["prompt"]],
                    max_new_tokens=doc.get("max_new_tokens"),
                    tenant=self.headers.get(m2kt_obs.TENANT_HEADER, ""),
                    traceparent=self.headers.get(
                        m2kt_obs.TRACEPARENT_HEADER, ""))
                handoff = replica.prefill(req)
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            self._send(200, handoff.to_bytes(),
                       "application/octet-stream")

    httpd = ThreadingHTTPServer(("", PORT), Handler)
    print(f"[m2kt] fleet prefill on :{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()


def main() -> None:
    if FLEET_ROLE == "router":
        run_router()
        return
    if FLEET_ROLE == "autoscaler":
        run_autoscaler()
        return
    decide_engine_knobs()
    if FLEET_ROLE == "prefill":
        run_prefill()
        return
    # decode role and classic single-pod serving share this path
    if os.environ.get("M2KT_NUM_SLICES", "1") not in ("", "1"):
        print("[m2kt] WARNING: M2KT_NUM_SLICES ignored — the serving "
              "engine is single-device", flush=True)
    os.environ.setdefault("M2KT_FLEET_ROLE", "decode")
    dev = device()
    setup_compilation_cache(COMPILE_CACHE_DIR)
    telem_srv = None
    if METRICS_PORT > 0:
        telem_srv = m2kt_obs.start_telemetry_server(
            METRICS_PORT,
            tracer=(m2kt_obs.get_tracer()
                    if m2kt_obs.tracing_enabled() else None))
        if telem_srv is not None:
            print(f"[m2kt] telemetry on :{telem_srv.port}", flush=True)
    # per-request tracing (M2KT_TRACE, default on): the engine records
    # admit/queue-wait/prefill/decode spans into the bounded ring; the
    # teardown flush parks them for the crash flight recorder
    if m2kt_obs.tracing_enabled():
        m2kt_obs.install_ring_flush()
    server = _Server(dev)
    if server.weight_plane is not None:
        _start_weights_server(server)
    draining = threading.Event()
    if telem_srv is not None:
        # /readyz: 503 while warming, 503 again once draining starts;
        # /healthz stays alive-only
        telem_srv.set_readiness(
            lambda: "draining" if draining.is_set()
            else ("serving" if server.ready.is_set() else "starting"))
    # the usage ledger and the anomaly watchdog read the engine's records,
    # which start once it is warm
    server.ready.wait()
    # usage ledger (M2KT_USAGE, default on): per-tenant snapshots served
    # at /usage and flushed to m2kt-usage.jsonl on exit
    usage_ledger = None
    if m2kt_obs.usage_enabled():
        usage_ledger = m2kt_obs.UsageLedger(
            registry=m2kt_obs.default_registry())
        usage_ledger.add_source(
            m2kt_obs.engine_source(server.engine), "engine")
        usage_ledger.start()
        m2kt_obs.install_usage_flush(usage_ledger)
        if telem_srv is not None:
            telem_srv.set_ledger(usage_ledger)
    # anomaly-triggered auto-profiling (M2KT_DIAG, default on)
    watchdog, diag_thread = None, None
    diag_stop = threading.Event()
    if m2kt_obs.diag_enabled():
        watchdog = m2kt_obs.DiagWatchdog(
            registry=m2kt_obs.default_registry(),
            slo=getattr(server.engine, "slo", None),
            tracer=(m2kt_obs.get_tracer()
                    if m2kt_obs.tracing_enabled() else None),
            ledger=usage_ledger)

        def _diag_loop() -> None:
            while not diag_stop.wait(5.0):
                try:
                    watchdog.check()
                except Exception:  # noqa: BLE001 - diagnostics are advisory
                    pass

        diag_thread = threading.Thread(target=_diag_loop, daemon=True,
                                       name="m2kt-diag")
        diag_thread.start()

    def _begin_drain() -> bool:
        # shared by POST /drain and SIGTERM: flip /readyz, refuse new
        # admissions, give in-flight requests M2KT_DRAIN_GRACE_S
        draining.set()
        grace = float(os.environ.get("M2KT_DRAIN_GRACE_S", "30"))
        clean = server.drain(grace)
        print(f"[m2kt] drained clean={clean} grace={grace}s", flush=True)
        return clean

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, doc: dict) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _deadline(self):
            # X-M2KT-Deadline: remaining seconds, stamped per hop by the
            # router — the only clock any wait in this process uses
            raw = self.headers.get(DEADLINE_HEADER, "")
            try:
                return float(raw) if raw else None
            except ValueError:
                return None

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                if server.ready.is_set():
                    self._reply(200, {"status": "ok"})
                else:
                    self._reply(503, {"status": "warming"})
            elif self.path == "/readyz":
                if draining.is_set():
                    self._reply(503, {"status": "draining"})
                elif server.ready.is_set():
                    self._reply(200, {"status": "serving"})
                else:
                    self._reply(503, {"status": "starting"})
            elif self.path == "/stats":
                self._reply(200, dict(
                    server.engine.stats(), warm=server.warm_stats,
                    launches={k.name: k.launches for k in KERNELS}))
            else:
                self._reply(404, {"error": "not found"})

        def _refused(self, err) -> bool:
            """Reply for an admission or wait failure; False when ``err``
            is none of them."""
            if isinstance(err, DeadlineExceeded):
                self._reply(504, {"error": str(err)})
            elif isinstance(err, EngineDraining):
                self._reply(503, {"error": str(err)})
            elif isinstance(err, (ValueError, KeyError)):
                self._reply(400, {"error": str(err)})
            else:
                return False
            return True

        def do_POST(self) -> None:  # noqa: N802 (stdlib API)
            # the body is read before any reply: a connection closed with
            # unread bytes is reset, and the reset can beat the reply
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if self.path == "/drain":
                # synchronous: the preStop hook blocks on this reply; the
                # listener stays up for probes until SIGTERM stops it
                self._reply(200, {"drained": _begin_drain()})
                return
            if draining.is_set():
                self._reply(503, {"error": "replica is draining"})
                return
            if self.path == "/swap":
                try:
                    doc = json.loads(body or b"{}")
                    raw = doc.get("version")
                    installed = server.swap(
                        version=int(raw) if raw is not None else None,
                        deadline_s=self._deadline())
                except Exception as e:  # noqa: BLE001 - failed swap is an
                    # error reply, never a dead listener
                    if not self._refused(e):
                        self._reply(500, {"error": str(e)})
                    return
                self._reply(200, {"weights_version": installed})
                return
            if self.path == "/install":
                # fleet decode role: seat a prefill replica's KV handoff
                try:
                    comp = server.install(body, deadline_s=self._deadline())
                except (DeadlineExceeded, EngineDraining, ValueError,
                        KeyError) as e:
                    self._refused(e)
                    return
                self._reply(200, {"rid": comp.rid,
                                  "prompt_len": comp.prompt_len,
                                  "tokens": comp.tokens,
                                  "finish_reason": comp.finish_reason})
                return
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                doc = json.loads(body)
                prompt = [int(t) for t in doc["prompt"]]
                max_new = int(doc.get("max_new_tokens", 32))
                if doc.get("stream"):
                    self._stream(doc, prompt, max_new)
                    return
                # fleet headers: tenant attribution + the router's span
                # traceparent, so this pod's span lands in its trace
                comp = server.generate(
                    prompt, max_new,
                    tenant=self.headers.get(m2kt_obs.TENANT_HEADER, ""),
                    traceparent=self.headers.get(
                        m2kt_obs.TRACEPARENT_HEADER, ""),
                    deadline_s=self._deadline(),
                    adapter=str(doc.get("adapter", "") or ""))
            except (DeadlineExceeded, EngineDraining, ValueError, KeyError,
                    json.JSONDecodeError) as e:
                self._refused(e)
                return
            self._reply(200, {"tokens": comp.tokens,
                              "finish_reason": comp.finish_reason})

        def _stream(self, doc, prompt, max_new) -> None:
            """``"stream": true`` branch of /generate: server-sent events,
            one ``data:`` line per token as the engine commits it, closing
            with a ``finish_reason`` doc. A consumer that falls behind
            gets a terminal ``lagged`` event instead of stalling the step
            thread."""
            deadline_s = self._deadline()
            try:
                rid, sub = server.generate_stream(
                    prompt, max_new,
                    tenant=self.headers.get(m2kt_obs.TENANT_HEADER, ""),
                    traceparent=self.headers.get(
                        m2kt_obs.TRACEPARENT_HEADER, ""),
                    deadline_s=deadline_s,
                    adapter=str(doc.get("adapter", "") or ""))
            except EngineDraining as e:
                self._reply(503, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            budget = deadline_s if deadline_s is not None else 300.0
            give_up = time.monotonic() + max(0.1, budget)
            try:
                while True:
                    try:
                        kind, payload = sub.get(timeout=0.25)
                    except queue.Empty:
                        if time.monotonic() > give_up:
                            self.wfile.write(
                                b'data: {"finish_reason": "deadline"}\n\n')
                            break
                        continue
                    if kind == "token":
                        event = json.dumps({"token": int(payload)})
                        self.wfile.write(f"data: {event}\n\n".encode())
                        self.wfile.flush()
                    elif kind == "lagged":
                        self.wfile.write(
                            b'data: {"finish_reason": "lagged"}\n\n')
                        break
                    else:  # finish
                        event = json.dumps({"finish_reason": payload})
                        self.wfile.write(f"data: {event}\n\n".encode())
                        break
            except OSError:
                pass  # consumer hung up mid-stream; the engine finishes
            finally:
                server.reap(rid, sub)

        def log_message(self, *args) -> None:  # quiet per-request noise
            pass

    httpd = ThreadingHTTPServer(("", PORT), Handler)

    def _on_term(signum, frame):
        # SIGTERM runs the same drain /drain does (idempotent), then
        # stops the listener and lets the process exit
        def _stop():
            _begin_drain()
            httpd.shutdown()

        threading.Thread(target=_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    print(f"[m2kt] serving on :{httpd.server_address[1]} "
          f"max_batch={MAX_BATCH} max_seq={MAX_SEQ} kv_block={KV_BLOCK} "
          f"quant={SERVE_QUANT} kernels={SERVE_KERNELS} spec_k={SPEC_K} "
          f"async={ASYNC_DECODE} substeps={DECODE_SUBSTEPS}", flush=True)
    httpd.serve_forever()
    # no thread may run torch while the interpreter tears down: a
    # capture's torch.profiler trace (the watchdog fires on the SLO's fast
    # burn, after a shed request) still running at exit crashed the
    # process (SIGSEGV) after a clean drain
    diag_stop.set()
    if diag_thread is not None:
        diag_thread.join(30)
        watchdog.wait(60)
    server.close()


if __name__ == "__main__":
    sys.exit(main())
