"""Continuous-batching greedy decode engine over the paged KV cache: the
synchronous engine of ``move2kube_tpu/serving/engine.py`` that one fleet
replica runs.

Sequences are admitted into free decode slots mid-flight (up to
``admit_burst`` admissions per step, so running sequences never stall
behind an admission burst) and release their slot and pages the step
they finish. A prompt prefills padded to the smallest configured bucket
that fits; every decode step runs all ``max_batch`` rows, with idle rows
redirected at the null page (:func:`~.kvcache.sanitized_views`).

The engine runs eagerly under ``torch.inference_mode()`` on the model's
device: on the card, prefill attention is the flash kernel (with
``attn_impl="flash"``) and every single-token pass's attention is the
paged-decode kernel (``csrc/paged_decode_int8.cu`` on an int8 cache).
The paths below add no kernel; each is a sequence of those passes:

- **Prefix cache** (``prefix_cache``, :mod:`.prefixcache`): a hit skips
  the prefill. The shared prefix's pages go into the slot's block table
  (with one copy-on-write page copy where the slot's first write lands in
  a shared page), and the prompt's uncached suffix is fed one token per
  decode step; argmax outputs are discarded while forced tokens remain,
  so the first generated token comes from the logits the uncached path
  computes. Hits are taken only when the suffix is short (default ``2 *
  block_size`` tokens); longer misses prefill cold and donate their
  prompt pages to the cache.
- **Speculative decoding** (``spec_k`` > 0): a draft made of the
  target's own first ``num_layers // spec_draft_factor`` blocks,
  embedding, norm and head (:func:`~.quant.draft_model_from`), with its
  own page pools of identical geometry, proposes ``spec_k`` tokens with
  ``spec_k + 1`` single-token passes; the target verifies the window
  with ``spec_k + 1`` passes that write K/V in place and leave
  ``seq_lens`` alone. Acceptance is greedy-exact, so spec-on and
  spec-off decode the same token stream; both caches' ``seq_lens`` are
  set on the host to the accepted length.
- **Chunked prefill** (``chunk_prefill`` > 0): a prompt longer than the
  chunk is seated up front and fed ``chunk_prefill`` tokens per engine
  step as single-token passes of its own row, after the decode batch.
  The slot sits out the decode batch until its final chunk lands.
- **Drain and deadlines**: a draining engine refuses new work
  (:class:`EngineDraining`) and finishes what it holds; a request whose
  propagated deadline is expired or provably unmeetable from the
  engine's own decode-latency history is refused
  (:class:`DeadlineExceeded`), and one that expires while queued
  completes ``"shed"``.
- **Metrics and tracing** (:mod:`move2kube_tpu_torch.obs`): the
  reference's ``m2kt_serve_*`` families on the engine's registry (a
  private one unless the caller passes one), a ``serve.request`` root
  span per request (adopting the caller's ``traceparent``) with
  ``serve.*`` children timed by the step's own clock readings, and the
  per-tenant SLO ledger.
- **Scheduler plane** (:mod:`.sched`): when the tenant spec ranks
  tenants into distinct priority classes, an admission that finds no
  free slot (or no free pages) preempts the lowest-priority, most
  recently admitted slot. Its pages free at once and its Completion
  carries ``finish_reason="preempted"``: the router resumes it
  token-exactly by feeding the journal as part of the prompt.
- **Multi-LoRA** (``max_loras`` > 0, :mod:`.sched.lora`): each slot's
  adapter row rides every prefill, decode and chunk pass as the model's
  ``lora=`` operand, a gather of the stacked A/B and two products added
  to the fp32 logits (row 0 is the base model). Spec decode and LoRA
  exclude each other.
- **Live weight swap** (:meth:`ServingEngine.install_weights`) between
  steps, validated before anything is installed; it rebinds this
  engine's own modules and never writes into tensors it shares with the
  caller or with sibling engines.
- **Quant-drift audit** (``quant_audit_rate``): a deterministic share of
  cold prefills is replayed through the retained fp model (one more
  flash prefill, pass kind ``audit``) and the logit drift exported.
- **Disaggregated prefill** (:meth:`ServingEngine.install_prefilled`):
  a slot is seated from K/V prefilled elsewhere
  (:mod:`move2kube_tpu_torch.serving.fleet.disagg`).
- **Cost model** (:meth:`ServingEngine.cost_report`): FLOPs, bytes,
  roofline class and decode MFU of every bucketed pass, counted on one
  run each (:mod:`move2kube_tpu_torch.obs.costmodel`) that touches no
  live page; the usage ledger reads the engine through
  :func:`move2kube_tpu_torch.obs.ledger.engine_source`.

Low-precision serving (``quant``, :mod:`.quant`): the engine quantizes
the model's weights once, at construction (per-output-channel int8,
dequantized inside each step), and keeps only the quantized copy (and
the caller's fp model when it audits); ``int8-kv`` also stores the paged
KV cache as int8 rows with per-row scales, which every page copy moves
with the rows. Not ported yet (ROADMAP.md, Queue 1 item 4h): the async
decode pipeline; its gauge is registered and stays at zero.

Env knobs (the JAX engine's names):

- ``M2KT_SERVE_MAX_BATCH``  concurrent decode slots   (default 8)
- ``M2KT_SERVE_MAX_SEQ``    max context per sequence  (default 256)
- ``M2KT_KV_BLOCK_SIZE``    tokens per KV-cache page  (default 16)
- ``M2KT_SERVE_BUCKETS``    prefill buckets, comma-sep (default: powers
  of two from 32 up to max_seq)
- ``M2KT_SERVE_ADMIT_BURST`` admissions per step; <= 0 = all free slots
  (default 1)
- ``M2KT_SERVE_PREFIX_CACHE`` cross-request prefix sharing (default off)
- ``M2KT_PREFIX_MAX_SUFFIX`` longest uncached suffix a hit may feed
  before falling back to a cold prefill (default 2 pages)
- ``M2KT_SERVE_QUANT``      serving quant policy off|int8|int8-kv
  (default off; an unknown name means off)
- ``M2KT_SPEC_K``           speculative proposal length; 0 disables
  (default 0)
- ``M2KT_SCHED_CHUNK_PREFILL`` chunk size of chunked prefill; 0 disables
  (default 0)
- ``M2KT_SCHED_TENANTS``    scheduler tenant spec; priorities drive
  preemption here, quotas are enforced at the router (default empty =
  never preempt); ``M2KT_SCHED_PRIORITIES`` and ``M2KT_SCHED_QUOTAS``
  are its split forms
- ``M2KT_SCHED_MAX_LORAS``  resident LoRA adapter rows; 0 disables
  (default 0)
- ``M2KT_LORA_RANK``        max adapter rank the stacks hold (default 8)
- ``M2KT_QUANT_AUDIT_RATE`` share of cold prefills audited against the
  fp weights under a weight-quantizing policy (default 0)
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
import weakref
from collections import deque

import numpy as np
import torch

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.obs import numerics as numericslib
from move2kube_tpu_torch.obs import slo as slolib
from move2kube_tpu_torch.obs import tracing
from move2kube_tpu_torch.obs.metrics import Registry
from move2kube_tpu_torch.serving import quant as quantlib
from move2kube_tpu_torch.serving import sched as schedlib
from move2kube_tpu_torch.serving.kvcache import (
    NULL_PAGE,
    PAGE_KEYS,
    PageAllocator,
    copy_page,
    init_cache,
    install_block_table,
    pages_for,
    sanitized_views,
    scatter_prefill,
    spec_for_model,
)
from move2kube_tpu_torch.serving.prefixcache import PrefixCache, PrefixHit

# decode steps run from sub-ms to tens of ms; span both so percentile
# interpolation has resolution at either end
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

# request-shape buckets (tokens): power-of-two edges matching the
# prefill bucket ladder
LENGTH_BUCKETS = (16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0,
                  2048.0, 4096.0)

# the model passes the engine runs, by kind: each launches one attention
# kernel per layer of the model it runs (flash for the prefills and the
# quant audit's fp forward, paged decode for every single-token pass)
PASS_KINDS = ("prefill", "decode", "verify", "chunk", "draft_prefill",
              "draft_decode", "audit")


def _default_buckets(max_seq: int) -> tuple[int, ...]:
    buckets, b = [], 32
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return tuple(buckets)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 256
    block_size: int = 16
    buckets: tuple[int, ...] = ()
    max_new_tokens: int = 32   # per-request default
    eos_id: int | None = None
    admit_burst: int = 1       # admissions per step; <= 0 = all free slots
    prefix_cache: bool = False
    prefix_max_suffix: int = 0  # 0 -> 2 * block_size
    quant: str = "off"         # off | int8 | int8-kv (serving/quant.py)
    # quant-drift audit: share of cold admissions whose prefill is re-run
    # through the retained fp model, exporting the max-rel logit error as
    # m2kt_serve_quant_drift. 0 = off, no fp model kept
    quant_audit_rate: float = 0.0
    spec_k: int = 0            # draft proposals per step; 0 = no spec decode
    # draft depth divisor: num_layers // factor layers (1 = full-depth
    # draft, acceptance 1.0)
    spec_draft_factor: int = 2
    # chunked prefill: prompts longer than this many tokens prefill as
    # interleaved single-token chunks of this size (0 = off). Each chunk
    # token is one eager single-token pass, so chunking stalls the running
    # streams far longer than a cold prefill would: at Llama-8B width on
    # an H100 80GB (700 W) a step carrying a 64-token chunk took 2.8-3.4 s
    # against 46-63 ms without one, and a 256-token prompt 11-13 s, where
    # a cold prefill of 1000 tokens takes about 0.1 s (chip_smoke.py,
    # fleet_slice_phase and the serving profile). Leave it off on the card
    # until the single-token pass runs as a CUDA graph.
    chunk_prefill: int = 0
    # scheduler plane (serving/sched): the combined tenant spec plus the
    # split forms, merged at construction. Priorities order preemption
    # in the engine; quotas only bite at the router
    sched_tenants: str = ""
    sched_priorities: str = ""
    sched_quotas: str = ""
    # multi-LoRA: resident adapter rows (0 = off) and the max rank the
    # stacked A/B weights hold
    max_loras: int = 0
    lora_rank: int = 8

    def resolved_buckets(self) -> tuple[int, ...]:
        buckets = self.buckets or _default_buckets(self.max_seq)
        buckets = tuple(sorted(set(min(b, self.max_seq) for b in buckets)))
        if buckets[-1] < self.max_seq:
            buckets = buckets + (self.max_seq,)
        return buckets

    @classmethod
    def from_env(cls, **overrides) -> "EngineConfig":
        def _int(name, default):
            try:
                return int(os.environ.get(name, "") or default)
            except ValueError:
                return default

        buckets: tuple[int, ...] = ()
        raw = os.environ.get("M2KT_SERVE_BUCKETS", "")
        if raw:
            try:
                buckets = tuple(int(x) for x in raw.split(",") if x.strip())
            except ValueError:
                buckets = ()
        cfg = dict(
            max_batch=_int("M2KT_SERVE_MAX_BATCH", cls.max_batch),
            max_seq=_int("M2KT_SERVE_MAX_SEQ", cls.max_seq),
            block_size=_int("M2KT_KV_BLOCK_SIZE", cls.block_size),
            buckets=buckets,
            admit_burst=_int("M2KT_SERVE_ADMIT_BURST", cls.admit_burst),
            prefix_cache=os.environ.get(
                "M2KT_SERVE_PREFIX_CACHE", "").lower() in ("1", "true", "on"),
            prefix_max_suffix=_int("M2KT_PREFIX_MAX_SUFFIX",
                                   cls.prefix_max_suffix),
            quant=(lambda q: q if q in quantlib.QUANT_OPTIONS else "off")(
                os.environ.get("M2KT_SERVE_QUANT", "") or cls.quant),
            quant_audit_rate=numericslib.audit_rate(),
            spec_k=max(0, _int("M2KT_SPEC_K", cls.spec_k)),
            chunk_prefill=max(0, _int("M2KT_SCHED_CHUNK_PREFILL",
                                      cls.chunk_prefill)),
            # a bad value warns inside the spec parser; it never takes
            # the engine down
            sched_tenants=os.environ.get("M2KT_SCHED_TENANTS",
                                         cls.sched_tenants),
            sched_priorities=os.environ.get("M2KT_SCHED_PRIORITIES",
                                            cls.sched_priorities),
            sched_quotas=os.environ.get("M2KT_SCHED_QUOTAS",
                                        cls.sched_quotas),
            max_loras=max(0, _int("M2KT_SCHED_MAX_LORAS", cls.max_loras)),
            lora_rank=max(1, _int("M2KT_LORA_RANK", cls.lora_rank)),
        )
        cfg.update(overrides)
        return cls(**cfg)


class DeadlineExceeded(ValueError):
    """The request's propagated deadline cannot be met: already expired,
    or provably unmeetable from the engine's own decode-latency history.
    A ValueError, so every reject path treats it as the caller's
    problem, not the replica's."""


class EngineDraining(RuntimeError):
    """submit() refused because the engine is draining: it finishes its
    in-flight work but admits nothing new. The caller (router) should
    re-route, not retry here."""


@dataclasses.dataclass
class Request:
    rid: str
    prompt: list[int]
    max_new_tokens: int | None = None
    # multi-tenant attribution ("" = the default tenant)
    tenant: str = ""
    # W3C traceparent of the caller's span: the engine's serve.request
    # root adopts its trace id so cross-process traces stitch
    traceparent: str = ""
    # remaining deadline budget (seconds) at submission; None = none.
    # Admission refuses requests that cannot finish inside it, and queued
    # requests that expire before a slot frees complete "shed"
    deadline_s: float | None = None
    # named LoRA adapter to decode under ("" = base model); must be
    # registered in the engine's adapter store or submit rejects
    adapter: str = ""


@dataclasses.dataclass
class Completion:
    rid: str
    prompt_len: int
    tokens: list[int]
    # "eos" | "length" | "shed" | "preempted": preempted is paused work,
    # not failure; the router resumes it token-exactly from its journal
    # (the tokens so far already rode on_token)
    finish_reason: str
    # the engine's weight generation at release time: a stream that rode
    # across a live swap finishes stamped with the new version
    weights_version: int = 0


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list[int]
    tokens: list[int]
    last_token: int
    max_new: int
    # prompt suffix a prefix-cache hit still owes the cache: fed one
    # token per decode step; argmax output is discarded until empty
    pending: list[int] = dataclasses.field(default_factory=list)
    prefix_hit: bool = False
    # scheduler plane: admission order and priority class (preemption
    # picks the lowest class, most recent seq), and the slot's row in the
    # adapter store
    seq: int = 0
    priority: int = 1
    adapter_row: int = 0
    # a chunking slot is excluded from decode until its whole prompt
    # has landed
    chunking: bool = False


@dataclasses.dataclass
class _ChunkJob:
    """The (single) in-flight chunked prefill: one chunk of the slot's
    prompt runs per engine step, after the decode batch."""
    slot_idx: int
    done: int = 0  # prompt tokens already written into the slot's pages


class ServingEngine:
    """Greedy-decoding continuous-batching engine for the port's LMs,
    ``Llama`` (MoE included) and ``GPT2`` (anything whose ``forward``
    carries the prefill and paged-decode modes; a model with a learned
    position table of ``n_positions`` needs ``max_seq <=
    n_positions``). The KV cache lives on ``device`` (the card by
    default), which must be where the model's parameters are. Under a
    quant policy that quantizes weights, ``self.model`` is the engine's
    quantized copy (:func:`~.quant.quantize_model`); the caller's model
    is kept only as the quant audit's fp reference (``quant_audit_rate``
    > 0).

    ``registry`` receives the engine's metric families (a private
    :class:`~move2kube_tpu_torch.obs.metrics.Registry` by default, so
    engines built in one process do not mix); ``tracer`` records the
    request spans (the process-wide recorder by default, none when
    ``M2KT_TRACE`` is off)."""

    def __init__(self, model, config: EngineConfig | None = None, *,
                 device=None, registry: Registry | None = None,
                 tracer: tracing.SpanRecorder | None = None) -> None:
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(f"model parameters are on {model_dev}, the "
                             f"engine's device is {self.device}")
        self.config = config or EngineConfig.from_env()
        n_positions = getattr(model.cfg, "n_positions", None)
        if n_positions is not None and self.config.max_seq > n_positions:
            # a learned position table: a position past it would be an
            # out-of-range index (an IndexError on the CPU, a device-side
            # assert on the card), where flax's Embed gives NaN rows
            raise ValueError(f"max_seq {self.config.max_seq} exceeds the "
                             f"model's n_positions {n_positions}")
        self.quant = quantlib.policy(self.config.quant)
        # quant-drift auditor: keep the caller's fp model so a share of
        # cold prefills can be replayed through it. Only when quantizing
        # and auditing: the fp weights stay resident beside the int8 ones
        self._audit_rate = (max(0.0, min(1.0, self.config.quant_audit_rate))
                            if self.quant.quantize_weights else 0.0)
        self._audit_model = model if self._audit_rate else None
        self._audit_accum = 0.0    # deterministic rate accumulator
        self._drift_last = 0.0
        self._drift_max = 0.0
        if self.quant.quantize_weights:
            model = quantlib.quantize_model(model)
        self.model = model
        # weight generation: bumped by install_weights (live swap);
        # stamped into completions, spans and m2kt_weights_version
        self.weights_version = 1
        self.buckets = self.config.resolved_buckets()
        self.cache_cfg = spec_for_model(
            model.cfg, block_size=self.config.block_size,
            max_batch=self.config.max_batch, max_seq=self.config.max_seq,
            cache_dtype=self.quant.cache_dtype)
        self._cache = init_cache(self.cache_cfg, model_dev)
        self._allocator = PageAllocator(self.cache_cfg.num_pages)
        self._slots: list[_Slot | None] = [None] * self.config.max_batch
        self._pending: deque[Request] = deque()
        # scheduler plane: tenant policies shared with the router;
        # priorities order preemption here, quotas bite at the router
        self.sched = schedlib.AdmissionController.from_specs(
            self.config.sched_tenants, self.config.sched_priorities,
            self.config.sched_quotas)
        self._preempt_enabled = self.sched.distinct_priorities()
        self._admit_seq = 0
        self._preempt_count = 0
        self.spec_k = max(0, self.config.spec_k)
        # multi-LoRA excludes spec decode: the draft shares the target's
        # head, and a proposer blind to the adapter would collapse
        # acceptance anyway
        self.max_loras = max(0, self.config.max_loras)
        if self.max_loras and self.spec_k:
            print("[m2kt] WARNING: M2KT_SCHED_MAX_LORAS is incompatible "
                  "with spec decode (M2KT_SPEC_K); disabling multi-LoRA",
                  flush=True)
            self.max_loras = 0
        self.adapters: schedlib.AdapterStore | None = None
        if self.max_loras:
            self.adapters = schedlib.AdapterStore(
                d_model=model.cfg.d_model, vocab=model.cfg.vocab_size,
                rank=max(1, self.config.lora_rank),
                max_loras=self.max_loras, device=model_dev)
        self._req_adapter: dict[str, int] = {}
        # chunked prefill: spec decode keeps its own window discipline
        # and opts out
        self.chunk_prefill = max(0, self.config.chunk_prefill)
        if self.chunk_prefill and self.spec_k:
            print("[m2kt] WARNING: M2KT_SCHED_CHUNK_PREFILL is "
                  "incompatible with spec decode (M2KT_SPEC_K); "
                  "disabling chunked prefill", flush=True)
            self.chunk_prefill = 0
        self._chunk_job: _ChunkJob | None = None
        self._chunk_count = 0
        # a spec verify window writes K/V up to spec_k positions past the
        # point a stream finishes; those writes are stale by construction
        # but must land inside the slot's own block table, so every
        # capacity check reserves them
        self._overrun_slack = self.spec_k
        # speculative decoding: the draft shares the target's modules and
        # has its own pools with IDENTICAL page geometry, so page indices
        # map 1:1 and every allocator/prefix-cache decision covers both
        self._draft_cache = None
        self._draft_model = None
        if self.spec_k:
            draft_cfg = quantlib.draft_config(
                model.cfg, self.config.spec_draft_factor)
            self._draft_cfg = draft_cfg
            self._draft_model = quantlib.draft_model_from(model, draft_cfg)
            self._draft_cache = init_cache(dataclasses.replace(
                self.cache_cfg, num_layers=draft_cfg.num_layers), model_dev)
        self._prefix: PrefixCache | None = None
        if self.config.prefix_cache:
            self._prefix = PrefixCache(self.cache_cfg.block_size,
                                       self._allocator)
        # opt-in logit capture for the equivalence checks: per-rid rows of
        # the logits each *generated* token was argmaxed from
        self.capture_logits = False
        self.logit_log: dict[str, list[np.ndarray]] = {}
        # token-emission hook: called ``on_token(rid, token)`` the moment
        # a generated token lands in its slot, at every emission site
        self.on_token = None
        self._decode_time = 0.0
        self._decode_tokens = 0
        self._decode_steps = 0
        self._prefill_count = 0
        self._prefill_time = 0.0
        self._ttft_max = 0.0
        # model passes by kind (PASS_KINDS): what the attention kernels'
        # launch counts must come to
        self._passes = dict.fromkeys(PASS_KINDS, 0)
        self._submit_ts: dict[str, float] = {}
        self._req_tenant: dict[str, str] = {}
        # absolute (perf_counter) deadlines of queued requests
        self._deadline_abs: dict[str, float] = {}
        self._draining = False
        self._last_consume_done: float | None = None
        self._gap_total = 0.0
        self._busy_total = 0.0
        self.tracer = tracer if tracer is not None else (
            tracing.get() if tracing.enabled() else None)
        self._req_spans: dict[str, tracing.Span] = {}
        self.registry = registry if registry is not None else Registry()
        self._init_metrics()
        self.slo = slolib.SLOTracker(registry=self.registry)

    def _init_metrics(self) -> None:
        """The reference's families (``move2kube_tpu/serving/engine.py``
        ``_init_metrics``), same names, help, labels and buckets. The
        async pipeline's gauge (not ported) stays at zero."""
        reg = self.registry
        self._lat_hist = reg.histogram(
            "m2kt_serve_token_latency_seconds",
            "Per-token decode step latency", buckets=LATENCY_BUCKETS)
        self._ttft_hist = reg.histogram(
            "m2kt_serve_ttft_seconds",
            "Time from submit to first token (queue wait + prefill)",
            buckets=LATENCY_BUCKETS)
        self._queue_depth = reg.gauge(
            "m2kt_serve_queue_depth", "Requests waiting for a decode slot")
        self._active_slots = reg.gauge(
            "m2kt_serve_active_slots", "Decode slots currently occupied")
        self._slot_occupancy = reg.gauge(
            "m2kt_serve_slot_occupancy",
            "Fraction of decode slots occupied")
        self._page_util = reg.gauge(
            "m2kt_serve_page_pool_utilization",
            "Fraction of KV-cache pages allocated")
        self._admitted = reg.counter(
            "m2kt_serve_admitted_total", "Requests admitted into a slot")
        self._rejected = reg.counter(
            "m2kt_serve_rejected_total",
            "Requests rejected at submit (too long / empty)")
        self._deadline_shed = reg.counter(
            "m2kt_serve_deadline_shed_total",
            "Requests shed because their propagated deadline is "
            "expired, unmeetable, or passed while queued",
            labels=("reason",))
        self._completed = reg.counter(
            "m2kt_serve_completed_total", "Completed sequences by reason",
            labels=("reason",))
        self._decode_steps_total = reg.counter(
            "m2kt_serve_decode_steps_total", "Decode steps executed")
        self._tokens_total = reg.counter(
            "m2kt_serve_decode_tokens_total", "Tokens generated")
        self._prefix_hits = reg.counter(
            "m2kt_serve_prefix_hits_total",
            "Admissions served from the prefix cache (no prefill)")
        self._prefix_misses = reg.counter(
            "m2kt_serve_prefix_misses_total",
            "Admissions that ran a cold prefill")
        self._prefix_hit_tokens = reg.counter(
            "m2kt_serve_prefix_hit_tokens_total",
            "Prompt tokens whose K/V came from shared pages")
        self._cow_copies = reg.counter(
            "m2kt_serve_cow_copies_total",
            "Shared pages copy-on-written before a slot's first write")
        self._prefix_pages = reg.gauge(
            "m2kt_serve_prefix_cache_pages",
            "KV pages currently pinned by the prefix cache")
        self._sched_preempted = reg.counter(
            "m2kt_sched_preempted_total",
            "Slots evicted by the scheduler as paused work (the router "
            "journal resumes them token-exactly)", labels=("reason",))
        self._sched_chunked = reg.counter(
            "m2kt_sched_chunked_total",
            "Long prompts prefilled as interleaved decode-mode chunks",
            labels=("reason",))
        self._spec_proposed = reg.counter(
            "m2kt_serve_spec_proposed_total",
            "Draft tokens proposed to the verify step")
        self._spec_accepted = reg.counter(
            "m2kt_serve_spec_accepted_total",
            "Draft tokens accepted by the verify step")
        self._spec_acceptance = reg.gauge(
            "m2kt_serve_spec_acceptance_rate",
            "Accepted / proposed draft tokens (cumulative)")
        # per-tenant attribution lives in its own families, cardinality
        # capped: tenant K+1 and beyond collapse into the "other" series
        cap = slolib.max_tenants()
        self._tenant_ttft = reg.histogram(
            "m2kt_serve_tenant_ttft_seconds",
            "Time to first token by tenant", buckets=LATENCY_BUCKETS,
            labels=("tenant",), max_series=cap + 1)
        self._tenant_lat = reg.histogram(
            "m2kt_serve_tenant_token_latency_seconds",
            "Per-token decode latency by tenant", buckets=LATENCY_BUCKETS,
            labels=("tenant",), max_series=cap + 1)
        self._tenant_admitted = reg.counter(
            "m2kt_serve_tenant_admitted_total",
            "Requests admitted into a slot by tenant",
            labels=("tenant",), max_series=cap + 1)
        self._tenant_rejected = reg.counter(
            "m2kt_serve_tenant_rejected_total",
            "Requests rejected at submit by tenant",
            labels=("tenant",), max_series=cap + 1)
        self._tenant_prompt_tokens = reg.histogram(
            "m2kt_serve_tenant_prompt_tokens",
            "Prompt length (tokens) of completed requests by tenant",
            buckets=LENGTH_BUCKETS, labels=("tenant",), max_series=cap + 1)
        self._tenant_decode_tokens = reg.histogram(
            "m2kt_serve_tenant_decode_tokens",
            "Generated length (tokens) of completed requests by tenant",
            buckets=LENGTH_BUCKETS, labels=("tenant",), max_series=cap + 1)
        self._quant_mode = reg.gauge(
            "m2kt_serve_quant_mode",
            "Serving quant policy (0=off, 1=int8, 2=int8-kv)")
        self._quant_mode.set(quantlib.QUANT_OPTIONS.index(self.quant.name))
        self._quant_drift = reg.gauge(
            "m2kt_serve_quant_drift",
            "Max-rel logit error of the last audited prefill vs the fp "
            "reference weights (0 until a request is audited)")
        self._quant_audits = reg.counter(
            "m2kt_serve_quant_audit_total",
            "Cold admissions replayed through the fp reference path")
        self._weights_version_gauge = reg.gauge(
            "m2kt_weights_version",
            "Weight generation currently installed in the engine")
        self._weights_version_gauge.set(self.weights_version)
        self._dispatch_gap = reg.histogram(
            "m2kt_serve_dispatch_gap_seconds",
            "Host time between consuming decode step k and dispatching "
            "k+1 (0 when the async pipeline kept the device fed)",
            buckets=LATENCY_BUCKETS)
        self._host_overhead = reg.gauge(
            "m2kt_serve_host_overhead_ratio",
            "Fraction of serving wall time the device spent starved on "
            "the host: dispatch gaps / (gaps + device-busy time)")
        # the synchronous loop never has a window in flight
        reg.gauge(
            "m2kt_serve_inflight_windows",
            "Async decode windows dispatched but not yet consumed").set(0)
        self._total_pages = max(1, self.cache_cfg.num_pages - 1)
        # /metrics re-renders gauges from the host-side snapshot taken at
        # the last step-sync point: a scrape never reads a device tensor
        self._gauge_snapshot: dict = {}
        self._update_occupancy()
        # the hook holds the engine weakly: a bound method would make a
        # cycle (engine -> registry -> hook -> engine) that keeps a dead
        # engine's KV pools and model on the card until the cyclic GC runs
        refresh = weakref.WeakMethod(self._refresh_gauges)

        def hook() -> None:
            fn = refresh()
            if fn is not None:
                fn()

        reg.add_collect_hook(hook)

    def _close_ttft(self, rid: str, ttft: float,
                    root: tracing.Span | None = None) -> None:
        """Close a request's TTFT: the fleet histogram, the tenant
        histogram, the SLO ledger and the root span all see one
        reading."""
        self._ttft_hist.observe(ttft)
        self._ttft_max = max(self._ttft_max, ttft)
        tenant = self._req_tenant.get(rid, "default")
        self._tenant_ttft.labels(tenant).observe(ttft)
        self.slo.record(tenant, ok=True, ttft_s=ttft)
        if root is not None:
            root.attrs["ttft_s"] = ttft

    def _update_occupancy(self) -> None:
        """Snapshot the occupancy gauges' inputs at a step-sync point.
        Everything here is host state (slot list, allocator free list,
        prefix index); nothing derived from a device tensor may be read
        at scrape time (:meth:`_refresh_gauges`)."""
        active = sum(1 for s in self._slots if s is not None)
        snap = {
            "queue_depth": len(self._pending),
            "active_slots": active,
            "slot_occupancy": active / max(1, self.config.max_batch),
            "page_util": 1.0 - self._allocator.available / self._total_pages,
        }
        if self._prefix is not None:
            snap["prefix_pages"] = self._prefix.total_pages
        self._gauge_snapshot = snap
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        """Re-set the occupancy gauges from the cached snapshot: a
        registry collect hook on every /metrics render, touching nothing
        but host floats."""
        snap = self._gauge_snapshot
        if not snap:
            return
        self._queue_depth.set(snap["queue_depth"])
        self._active_slots.set(snap["active_slots"])
        self._slot_occupancy.set(snap["slot_occupancy"])
        self._page_util.set(snap["page_util"])
        if "prefix_pages" in snap:
            self._prefix_pages.set(snap["prefix_pages"])

    # ------------------------------------------------------------------
    # device passes
    # ------------------------------------------------------------------

    def _lora_args(self, rows=None):
        """The model's ``lora=`` operand when multi-LoRA is on: the
        stacked A/B adapter weights plus each row's adapter (every slot's
        by default). None when the engine serves no adapters."""
        if not self.max_loras:
            return None
        a, b = self.adapters.stacks()
        if rows is None:
            rows = [s.adapter_row if s is not None else 0
                    for s in self._slots]
        return a, b, torch.tensor(rows, dtype=torch.long, device=a.device)

    @torch.inference_mode()
    def _prefill(self, ids: torch.Tensor, bt_row: torch.Tensor, slot: int,
                 plen: int, draft: bool = False,
                 adapter_row: int = 0) -> torch.Tensor:
        """One bucketed prefill of the target (or the draft, into its own
        pools): K/V scattered into the slot's pages; returns the logits
        ``[bucket, vocab]`` (with the adapter's delta under LoRA)."""
        model = self._draft_model if draft else self.model
        cache = self._draft_cache if draft else self._cache
        self._passes["draft_prefill" if draft else "prefill"] += 1
        lora = None if draft else self._lora_args(rows=[adapter_row])
        logits, kvs = model(ids, return_kv=True, lora=lora)
        scatter_prefill(cache, kvs, slot, bt_row, plen,
                        self.cache_cfg.block_size)
        return logits[0]

    @torch.inference_mode()
    def _decode(self, tokens: torch.Tensor, active: torch.Tensor,
                draft: bool = False):
        """One single-token pass of every active row, advancing the
        *same* cache's ``seq_lens`` in place (the draft's own when
        ``draft``)."""
        model = self._draft_model if draft else self.model
        cache = self._draft_cache if draft else self._cache
        self._passes["draft_decode" if draft else "decode"] += 1
        # sanitize freed/idle slots: their stale tables must not write
        # into pages the allocator may have handed to someone else
        bt, pos = sanitized_views(cache, active)
        logits = self._pass(model, cache, tokens, pos, bt,
                            None if draft else self._lora_args())
        cache["seq_lens"] += active.to(torch.int32)
        return logits, torch.argmax(logits, dim=-1)

    @staticmethod
    def _pass(model, cache: dict, tokens: torch.Tensor, pos: torch.Tensor,
              bt: torch.Tensor, lora=None) -> torch.Tensor:
        """One single-token pass over ``cache``'s pages: row i consumes
        ``tokens[i]`` at position ``pos[i]`` through table ``bt[i]``,
        writing its K/V there and attending to positions ``<= pos[i]``.
        Leaves the cache's ``seq_lens`` alone; returns the logits."""
        model_cache = {k: cache[k] for k in PAGE_KEYS if k in cache}
        model_cache["block_tables"] = bt
        model_cache["seq_lens"] = pos + 1
        logits, _ = model(tokens, positions=pos, cache=model_cache,
                          lora=lora)
        return logits

    @torch.inference_mode()
    def _verify(self, window: torch.Tensor, active: torch.Tensor):
        """The spec verify step: ``spec_k + 1`` single-token passes of the
        target, pass j consuming ``window[:, j]`` at position ``seq_len +
        j`` and writing its K/V in place. ``seq_lens`` is NOT advanced:
        the host sets it to the accepted length. Returns the logits after
        each consumed token ``[max_batch, spec_k + 1, vocab]``."""
        bt, base = sanitized_views(self._cache, active)
        rows = []
        for j in range(window.shape[1]):
            self._passes["verify"] += 1
            rows.append(self._pass(self.model, self._cache, window[:, j],
                                   base + j, bt))
        return torch.stack(rows, dim=1)

    @torch.inference_mode()
    def _chunk_pass(self, slot: int, tokens: list[int], start: int):
        """One chunk of a chunked prefill: the slot's prompt tokens
        ``tokens`` (positions ``start``..) fed as single-token passes of
        the slot's own row, K/V written page-wise at each position. Only
        this row runs: the reference runs every row with the others
        pointed at the null page and discards their results. Sets the
        slot's ``seq_lens`` to ``start + len(tokens)``; returns the logits
        after the chunk's last token ``[vocab]``."""
        cache = self._cache
        n = len(tokens)
        toks = torch.tensor(tokens, dtype=torch.int32, device=self.device)
        pos = torch.arange(start, start + n, dtype=torch.int32,
                           device=self.device)
        bt = cache["block_tables"][slot:slot + 1]
        lora = self._lora_args(rows=[self._slots[slot].adapter_row])
        logits = None
        for j in range(n):
            self._passes["chunk"] += 1
            logits = self._pass(self.model, cache, toks[j:j + 1],
                                pos[j:j + 1], bt, lora)
        cache["seq_lens"][slot] = start + n
        return logits[0]

    def _install(self, slot: int, bt_row: np.ndarray, seq_len: int,
                 cow: tuple[int, int] | None = None) -> None:
        """Point ``slot`` at ``bt_row`` holding ``seq_len`` tokens, in the
        target's cache and the draft's, and copy-on-write page ``cow[0]``
        into ``cow[1]`` in both."""
        row = torch.from_numpy(bt_row)
        for cache in (self._cache, self._draft_cache):
            if cache is None:
                continue
            install_block_table(cache, slot, row, seq_len)
            if cow is not None:
                copy_page(cache, cow[0], cow[1])

    # ------------------------------------------------------------------
    # host-side continuous batching
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        max_new = req.max_new_tokens or self.config.max_new_tokens
        tenant = slolib.clean_tenant(req.tenant)
        if self._draining:
            raise EngineDraining(f"{req.rid}: engine is draining")
        try:
            if plen < 1:
                raise ValueError(f"{req.rid}: empty prompt")
            if plen > self.buckets[-1]:
                raise ValueError(
                    f"{req.rid}: prompt length {plen} exceeds the largest "
                    f"prefill bucket {self.buckets[-1]}")
            if plen + max_new + self._overrun_slack > self.cache_cfg.max_seq:
                slack = (f" + overrun slack {self._overrun_slack}"
                         if self._overrun_slack else "")
                raise ValueError(
                    f"{req.rid}: prompt + max_new_tokens = {plen + max_new}"
                    f"{slack} exceeds max_seq {self.cache_cfg.max_seq}")
            reason = self._deadline_verdict(req.deadline_s, max_new)
            if reason is not None:
                self._deadline_shed.labels(reason=reason).inc()
                raise DeadlineExceeded(
                    f"{req.rid}: deadline {req.deadline_s:.3f}s {reason} "
                    f"for {max_new} new tokens")
            if req.adapter:
                if self.adapters is None:
                    raise ValueError(
                        f"{req.rid}: adapter {req.adapter!r} requested "
                        "but the engine serves no adapters "
                        "(M2KT_SCHED_MAX_LORAS=0)")
                # refcounted row acquire (an unknown adapter raises): the
                # store cannot drop the weights while this stream runs
                self._req_adapter[req.rid] = self.adapters.acquire(
                    req.adapter)
        except ValueError:
            self._rejected.inc()
            self._tenant_rejected.labels(tenant).inc()
            self.slo.record(tenant, ok=False)
            raise
        now = time.perf_counter()
        if req.deadline_s is not None:
            self._deadline_abs[req.rid] = now + req.deadline_s
        self._submit_ts[req.rid] = now
        self._req_tenant[req.rid] = tenant
        if self.tracer is not None:
            self._req_spans[req.rid] = self.tracer.start(
                "serve.request",
                attrs={"rid": req.rid, "prompt_len": plen,
                       "tenant": tenant},
                detached=True, remote_parent=req.traceparent or None)
        self._pending.append(req)
        self._update_occupancy()

    def _deadline_verdict(self, deadline_s: float | None,
                          max_new: int) -> str | None:
        """Shed reason for a deadline, or None when it is acceptable:
        "expired" = already past; "unmeetable" = the engine's observed
        p50 decode-step latency says ``max_new`` tokens cannot land inside
        the remaining budget (no history = benefit of the doubt)."""
        if deadline_s is None:
            return None
        if deadline_s <= 0:
            return "expired"
        p50 = self._lat_hist.quantile(0.50) if self._lat_hist.count else 0.0
        if p50 > 0 and max_new * p50 > deadline_s:
            return "unmeetable"
        return None

    def drain(self) -> None:
        """Stop admitting new requests; in-flight work keeps stepping.
        The caller pumps :meth:`step` until :meth:`has_work` clears."""
        self._draining = True

    def undrain(self) -> None:
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def _shed(self, req: Request, reason: str) -> Completion:
        """Complete a queued request as shed: counted, SLO-charged, and
        surfaced as a Completion so no waiter hangs."""
        self._deadline_shed.labels(reason=reason).inc()
        tenant = self._req_tenant.pop(req.rid, "default")
        self.slo.record(tenant, ok=False)
        self._submit_ts.pop(req.rid, None)
        self._deadline_abs.pop(req.rid, None)
        if self.adapters is not None:
            self.adapters.release(self._req_adapter.pop(req.rid, 0))
        self._completed.labels(reason="shed").inc()
        root = self._req_spans.pop(req.rid, None)
        if root is not None:
            self.tracer.end(root, attrs={"finish_reason": "shed",
                                         "shed_reason": reason})
        self._update_occupancy()
        return Completion(rid=req.rid, prompt_len=len(req.prompt),
                          tokens=[], finish_reason="shed")

    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    def _emit_token(self, rid: str, tok: int) -> None:
        cb = self.on_token
        if cb is not None:
            cb(rid, tok)

    def step(self) -> list[Completion]:
        """One engine iteration: admit pending requests into free slots
        (up to ``admit_burst``: a bucketed prefill, a block-table install
        on a prefix-cache hit, or a seat for a chunked prefill), then run
        one decode step (a spec window under ``spec_k``) for every active
        slot, then one chunk of the chunked prefill in flight. Returns
        the sequences that finished this iteration."""
        finished = self._admit_pending()
        if self.spec_k:
            return self._spec_step(finished)
        # a chunking slot owns pages and a block table but has no prompt
        # resident yet: it sits out the decode batch
        active = [s is not None and not s.chunking for s in self._slots]
        if not any(active):
            self._chunk_step(finished)
            self._update_occupancy()
            self._maybe_reset_gap()
            return finished
        tokens = torch.tensor(
            [s.last_token if on else 0 for s, on in zip(self._slots, active)],
            dtype=torch.int32, device=self.device)
        active_mask = torch.tensor(active, device=self.device)
        t0 = time.perf_counter()
        if self._last_consume_done is not None:
            # host bookkeeping between reading step k and launching k+1
            # is device idle time
            gap = max(0.0, t0 - self._last_consume_done)
            self._dispatch_gap.observe(gap)
            self._gap_total += gap
        logits, next_tokens = self._decode(tokens, active_mask)
        next_tokens = next_tokens.cpu().numpy()  # waits for the step
        dt = time.perf_counter() - t0
        self._busy_total += dt
        self._last_consume_done = t0 + dt
        self._host_overhead.set(
            self._gap_total / (self._gap_total + self._busy_total))
        # slots still feeding a cached prompt's suffix consume the step
        # but produce nothing: their argmax is discarded below
        produced = sum(1 for s, on in zip(self._slots, active)
                       if on and not s.pending)
        self._account_step(dt, produced)
        logits_np = (logits.float().cpu().numpy() if self.capture_logits
                     else None)
        for i, slot in enumerate(self._slots):
            if not active[i]:
                continue
            if slot.pending:
                # the cache covered positions < seq_len; the next prompt
                # token is ground truth, not the model's to choose
                slot.last_token = slot.pending.pop(0)
                continue
            rid = slot.req.rid
            tok = int(next_tokens[i])
            root = self._req_spans.get(rid)
            if slot.prefix_hit and not slot.tokens:
                # first generated token of a hit: TTFT closes here (the
                # cold path closes it at prefill)
                submit_ts = self._submit_ts.pop(rid, None)
                if submit_ts is not None:
                    self._close_ttft(rid, t0 + dt - submit_ts, root)
            self._tenant_lat.labels(
                self._req_tenant.get(rid, "default")).observe(dt)
            if logits_np is not None:
                self.logit_log.setdefault(rid, []).append(
                    logits_np[i].copy())
            slot.tokens.append(tok)
            slot.last_token = tok
            self._emit_token(rid, tok)
            if root is not None:
                # the step's own t0/dt readings: no clock call added
                self.tracer.record(
                    "serve.decode_step", t0, t0 + dt,
                    attrs={"token_index": len(slot.tokens)},
                    trace_id=root.trace_id, parent_id=root.span_id)
            done = self._finish_reason(slot, tok)
            if done:
                finished.append(self._release(i, done))
        self._chunk_step(finished)
        self._update_occupancy()
        self._maybe_reset_gap()
        return finished

    def _account_step(self, dt: float, produced: int) -> None:
        """One decode (or spec) step's time and tokens, into the counters
        and the latency histogram that both step paths share."""
        self._decode_time += dt
        self._decode_tokens += produced
        self._decode_steps += 1
        self._lat_hist.observe(dt)
        self._decode_steps_total.inc()
        self._tokens_total.inc(produced)

    def _maybe_reset_gap(self) -> None:
        """Restart dispatch-gap accounting when the engine goes idle: the
        wait for the next request stream is load, not host overhead."""
        if not self.has_work():
            self._last_consume_done = None

    def _chunk_step(self, finished: list[Completion]) -> None:
        """Run at most one chunk of the in-flight chunked prefill, after
        the decode batch, so the long prompt and the running streams
        interleave."""
        job = self._chunk_job
        if job is None:
            return
        slot_idx = job.slot_idx
        slot = self._slots[slot_idx]
        prompt = slot.req.prompt
        start = job.done
        count = min(self.chunk_prefill, len(prompt) - start)
        t0 = time.perf_counter()
        last = self._chunk_pass(slot_idx, list(prompt[start:start + count]),
                                start)
        job.done += count
        rid = slot.req.rid
        root = self._req_spans.get(rid)
        if job.done < len(prompt):
            if root is not None:
                self.tracer.record(
                    "serve.chunk_prefill", t0, time.perf_counter(),
                    attrs={"start": start, "count": count},
                    trace_id=root.trace_id, parent_id=root.span_id)
            return
        # final chunk: its last reading is the logits a whole bucketed
        # prefill produces for the prompt's last position; the first
        # generated token argmaxes from them and TTFT closes here
        last_np = last.float().cpu().numpy()  # waits for the chunk
        now = time.perf_counter()
        if root is not None:
            self.tracer.record(
                "serve.chunk_prefill", t0, now,
                attrs={"start": start, "count": count},
                trace_id=root.trace_id, parent_id=root.span_id)
        self._chunk_job = None
        slot.chunking = False
        self._prefill_count += 1
        tok = int(np.argmax(last_np))
        if self.capture_logits:
            self.logit_log.setdefault(rid, []).append(last_np.copy())
        slot.tokens.append(tok)
        slot.last_token = tok
        self._emit_token(rid, tok)
        submit_ts = self._submit_ts.pop(rid, None)
        if submit_ts is not None:
            self._close_ttft(rid, now - submit_ts, root)
        done = self._finish_reason(slot, tok)
        if done:
            finished.append(self._release(slot_idx, done))

    def _spec_step(self, finished: list[Completion]) -> list[Completion]:
        """One speculative engine iteration. Window layout per slot:
        ``X = [last_token, w_1 .. w_k]`` where the first ``f =
        min(len(pending), k)`` window tokens are forced ground truth (a
        prefix hit's prompt suffix) and the rest are draft proposals. The
        draft runs ``k + 1`` single-token passes (pass j writes ``X[j]``'s
        draft K/V and proposes ``X[j + 1]``; the last proposal is
        discarded), then the target verifies the window.

        Greedy-exact acceptance: proposal ``X[f+1+i]`` is accepted iff it
        equals the target's argmax after consuming ``X[0..f+i]``, and the
        first miss is replaced by that argmax (the bonus token), so every
        emitted token is the target's own greedy choice. K/V written past
        the accepted length is stale by construction: both caches'
        ``seq_lens`` are set to the accepted length, masking it until
        later steps overwrite it."""
        k = self.spec_k
        active = [s is not None for s in self._slots]
        if not any(active):
            self._update_occupancy()
            return finished
        # read before the draft runs: its passes advance the draft's
        # seq_lens (never the target's)
        base = self._cache["seq_lens"].cpu().numpy().copy()
        B = self.config.max_batch
        X = np.zeros((B, k + 1), np.int32)
        X[:, 0] = [s.last_token if s else 0 for s in self._slots]
        forced = np.zeros((B,), np.int64)
        for i, s in enumerate(self._slots):
            if s is not None and s.pending:
                f = min(len(s.pending), k)
                X[i, 1:1 + f] = s.pending[:f]
                forced[i] = f
        active_mask = torch.tensor(active, device=self.device)
        t0 = time.perf_counter()
        for j in range(k + 1):
            _, nxt = self._decode(
                torch.from_numpy(X[:, j].copy()).to(self.device),
                active_mask, draft=True)
            if j < k:
                proposals = nxt.cpu().numpy()
                fill = forced <= j  # rows whose slot j+1 is not forced
                X[fill, j + 1] = proposals[fill]
        logits = self._verify(torch.from_numpy(X).to(self.device),
                              active_mask)
        targets = torch.argmax(logits, dim=-1).cpu().numpy()  # blocks
        dt = time.perf_counter() - t0
        logits_np = (logits.float().cpu().numpy() if self.capture_logits
                     else None)
        produced = 0
        new_lens = base.copy()
        for i, slot in enumerate(list(self._slots)):
            if slot is None:
                continue
            rid = slot.req.rid
            f = int(forced[i])
            del slot.pending[:f]
            a = 0
            while f + 1 + a <= k and X[i, f + 1 + a] == targets[i, f + a]:
                a += 1
            self._spec_proposed.inc(k - f)
            self._spec_accepted.inc(a)
            if slot.pending:
                # suffix longer than the window: every input was ground
                # truth (f == k), nothing is emitted this step, and the
                # next window starts at the next owed prompt token (X[i, k]
                # is already written at base + k)
                slot.last_token = slot.pending.pop(0)
                new_lens[i] = base[i] + k + 1
                continue
            emitted = [int(targets[i, f + j]) for j in range(a + 1)]
            new_lens[i] = base[i] + f + a + 1
            slot.last_token = emitted[-1]
            root = self._req_spans.get(rid)
            if slot.prefix_hit and not slot.tokens:
                submit_ts = self._submit_ts.pop(rid, None)
                if submit_ts is not None:
                    self._close_ttft(rid, t0 + dt - submit_ts, root)
            self._tenant_lat.labels(
                self._req_tenant.get(rid, "default")).observe(dt)
            done = None
            for m, tok in enumerate(emitted):
                if logits_np is not None:
                    self.logit_log.setdefault(rid, []).append(
                        logits_np[i, f + m].copy())
                slot.tokens.append(tok)
                produced += 1
                self._emit_token(rid, tok)
                done = self._finish_reason(slot, tok)
                if done:
                    slot.last_token = tok
                    break
            if root is not None:
                self.tracer.record(
                    "serve.spec_step", t0, t0 + dt,
                    attrs={"proposed": k - f, "accepted": a,
                           "emitted": len(slot.tokens)},
                    trace_id=root.trace_id, parent_id=root.span_id)
            if done:
                finished.append(self._release(i, done))
        lens = torch.from_numpy(new_lens.astype(np.int32))
        self._cache["seq_lens"].copy_(lens)
        self._draft_cache["seq_lens"].copy_(lens)
        self._account_step(dt, produced)
        prop = self._spec_proposed.value
        if prop:
            self._spec_acceptance.set(self._spec_accepted.value / prop)
        self._update_occupancy()
        return finished

    def run(self, requests) -> list[Completion]:
        for req in requests:
            self.submit(req)
        completions: list[Completion] = []
        stall = 0
        while self.has_work():
            got = self.step()
            completions.extend(got)
            if not got and not any(s is not None for s in self._slots):
                stall += 1
                if stall > self.config.max_batch + 1:
                    raise RuntimeError(
                        "engine stalled: pending requests cannot be "
                        "admitted (page pool too small?)")
            else:
                stall = 0
        return completions

    def _finish_reason(self, slot: _Slot, tok: int) -> str | None:
        if self.config.eos_id is not None and tok == self.config.eos_id:
            return "eos"
        if len(slot.tokens) >= slot.max_new:
            return "length"
        return None

    def _release(self, slot_idx: int, reason: str) -> Completion:
        slot = self._slots[slot_idx]
        rid = slot.req.rid
        self._allocator.free(slot.pages)
        self._slots[slot_idx] = None
        self._completed.labels(reason=reason).inc()
        tenant = self._req_tenant.pop(rid, None) or "default"
        if reason != "preempted":
            # a preempted stream resumes and releases again: recording it
            # here would count the request's shape twice
            self._tenant_prompt_tokens.labels(tenant).observe(
                float(len(slot.req.prompt)))
            self._tenant_decode_tokens.labels(tenant).observe(
                float(len(slot.tokens)))
        self._deadline_abs.pop(rid, None)
        self._submit_ts.pop(rid, None)
        if self.adapters is not None:
            self.adapters.release(self._req_adapter.pop(rid, 0))
        root = self._req_spans.pop(rid, None)
        if root is not None:
            self.tracer.end(root, attrs={
                "finish_reason": reason, "tokens": len(slot.tokens),
                "weights_version": self.weights_version})
        self._update_occupancy()
        return Completion(rid=rid, prompt_len=len(slot.req.prompt),
                          tokens=list(slot.tokens), finish_reason=reason,
                          weights_version=self.weights_version)

    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(f"no bucket fits prompt length {plen}")

    def _admit_pending(self) -> list[Completion]:
        """Admit queued requests into free slots, up to ``admit_burst``
        per step (<= 0 means every free slot)."""
        burst = self.config.admit_burst
        limit = self.config.max_batch if burst <= 0 else burst
        finished: list[Completion] = []
        for _ in range(limit):
            admitted, done = self._admit_one()
            finished.extend(done)
            if not admitted:
                break
        return finished

    def _admit_one(self) -> tuple[bool, list[Completion]]:
        if not self._pending:
            return False, []
        req = self._pending[0]
        dl = self._deadline_abs.get(req.rid)
        if dl is not None and time.perf_counter() > dl:
            # expired while queued: sheds even with no free slot, so a
            # saturated engine still rejects dead-on-arrival work fast
            self._pending.popleft()
            return True, [self._shed(req, "queued_expired")]
        plen = len(req.prompt)
        max_new = req.max_new_tokens or self.config.max_new_tokens
        chunked = self.chunk_prefill > 0 and plen > self.chunk_prefill
        if chunked and self._chunk_job is not None:
            return False, []  # one chunk job at a time; wait for it
        pre: list[Completion] = []
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            # under slot pressure a higher-priority tenant's request may
            # evict the lowest-priority running stream (paused work, not
            # failure: the router journal resumes it token-exactly)
            victim = self._preempt_victim(req)
            if victim is None:
                return False, []
            pre.append(self._preempt(victim, "slots"))
            free = [victim]
        hit = self._try_prefix_hit(req, plen)
        if hit is not None:
            ok, done = self._admit_hit(req, free[0], hit, plen, max_new)
        elif chunked:
            ok, done = self._admit_chunked(req, free[0], plen, max_new)
        else:
            ok, done = self._admit_cold(req, free[0], plen, max_new)
        return ok or bool(pre), pre + done

    def _req_priority(self, req: Request) -> int:
        return self.sched.priority(
            self._req_tenant.get(req.rid, req.tenant))

    def _next_seq(self) -> int:
        self._admit_seq += 1
        return self._admit_seq

    def _new_slot(self, req: Request, **fields) -> _Slot:
        """A slot for ``req`` with its scheduler fields: priority class,
        admission order and adapter row."""
        return _Slot(req=req, priority=self._req_priority(req),
                     adapter_row=self._req_adapter.get(req.rid, 0),
                     seq=self._next_seq(), **fields)

    def _preempt_victim(self, req: Request) -> int | None:
        """Slot to evict for ``req``: the lowest-priority active slot,
        most recently admitted among ties, and only one strictly below
        the incoming request's class, so a flat (or empty) tenant spec
        never preempts. Chunking slots and slots still feeding a prefix
        suffix are not candidates."""
        if not self._preempt_enabled:
            return None
        prio = self._req_priority(req)
        best, best_key = None, None
        for i, s in enumerate(self._slots):
            if s is None or s.chunking or s.pending:
                continue
            if s.priority >= prio:
                continue
            key = (s.priority, -s.seq)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _preempt(self, slot_idx: int, reason: str) -> Completion:
        """Evict a slot as paused work: its pages free at once and its
        Completion carries ``finish_reason="preempted"``. The tokens so
        far already rode ``on_token`` into the router's journal, so the
        resume (journal fed as ground truth) is token-exact."""
        self._preempt_count += 1
        self._sched_preempted.labels(reason=reason).inc()
        return self._release(slot_idx, "preempted")

    def _alloc_preempting(self, req: Request, n: int
                          ) -> tuple[list[int] | None, list[Completion]]:
        """``_alloc_with_evict`` escalated to preemption: when shedding
        cold prefix-cache entries still leaves the pool short, release a
        strictly lower-priority slot's pages and hand its stream back to
        the router as paused work."""
        pre: list[Completion] = []
        pages = self._alloc_with_evict(n)
        while pages is None:
            victim = self._preempt_victim(req)
            if victim is None:
                break
            if not self._allocator.reclaimable(self._slots[victim].pages):
                # every page is shared (prefix cache, COW siblings):
                # evicting this stream frees nothing; keep it running
                break
            pre.append(self._preempt(victim, "pages"))
            pages = self._alloc_with_evict(n)
        return pages, pre

    def _count_admission(self, rid: str) -> None:
        self._count_admission_tenant(self._req_tenant.get(rid, "default"))

    def _count_admission_tenant(self, tenant: str) -> None:
        self._admitted.inc()
        self._tenant_admitted.labels(tenant).inc()

    def _new_bt_row(self) -> np.ndarray:
        return np.full((self.cache_cfg.max_pages_per_seq,), NULL_PAGE,
                       np.int32)

    def _admit_chunked(self, req: Request, slot_idx: int, plen: int,
                       max_new: int) -> tuple[bool, list[Completion]]:
        """Seat a long prompt for chunked prefill: allocate its full page
        run and block table up front (``seq_len`` starts at 0), mark the
        slot ``chunking`` so decode skips it, and let :meth:`_chunk_step`
        land the prompt one chunk per engine step."""
        n_pages = pages_for(plen + max_new + self._overrun_slack,
                            self.cache_cfg.block_size)
        pages, pre = self._alloc_preempting(req, n_pages)
        if pages is None:
            return False, pre
        self._pending.popleft()
        bt_row = self._new_bt_row()
        bt_row[:len(pages)] = pages
        self._install(slot_idx, bt_row, 0)
        self._slots[slot_idx] = self._new_slot(
            req, pages=pages, tokens=[], last_token=0, max_new=max_new,
            chunking=True)
        self._chunk_job = _ChunkJob(slot_idx=slot_idx)
        self._chunk_count += 1
        self._sched_chunked.labels(reason="long_prompt").inc()
        self._count_admission(req.rid)
        if self._prefix is not None:
            # chunked prompts are not donated to the prefix cache (their
            # pages fill across many steps); they count as misses
            self._prefix_misses.inc()
        self._update_occupancy()
        return True, pre

    def _alloc_with_evict(self, n: int) -> list[int] | None:
        pages = self._allocator.alloc(n)
        if pages is None and self._prefix is not None and len(self._prefix):
            # admission beats retention: shed cold prefix-cache entries
            self._prefix.evict(n - self._allocator.available)
            pages = self._allocator.alloc(n)
        return pages

    def _try_prefix_hit(self, req: Request, plen: int) -> PrefixHit | None:
        """A cached-prefix hit worth taking, or None (refs dropped).
        Coverage is capped at ``plen - 1`` so at least one prompt token
        always runs through decode and yields the first token's logits;
        hits whose uncached suffix would take longer to feed than a cold
        prefill are declined."""
        if self._prefix is None:
            return None
        hit = self._prefix.lookup(req.prompt)
        if hit is None:
            return None
        bs = self.cache_cfg.block_size
        c = min(hit.covered, plen - 1)
        max_suffix = self.config.prefix_max_suffix or 2 * bs
        if c < bs or plen - c > max_suffix:
            self._allocator.free(hit.pages)
            return None
        return PrefixHit(pages=hit.pages, covered=c)

    def _admit_hit(self, req: Request, slot_idx: int, hit: PrefixHit,
                   plen: int, max_new: int) -> tuple[bool, list[Completion]]:
        bs = self.cache_cfg.block_size
        c = hit.covered
        w = c // bs  # page index position c (the first write) lands in
        n_total = pages_for(plen + max_new + self._overrun_slack, bs)
        priv = self._alloc_with_evict(n_total - w)
        if priv is None:
            self._allocator.free(hit.pages)
            return False, []
        self._pending.popleft()
        bt_row = self._new_bt_row()
        bt_row[:w] = hit.pages[:w]
        bt_row[w:n_total] = priv
        t0 = time.perf_counter()
        cow = w < len(hit.pages)
        # position c lands inside a shared page (partial boundary, or a
        # fully covered prompt re-feeding its final token): write into a
        # private copy, never the shared original. Pages map 1:1 into the
        # draft's pools, so its table surgery mirrors the target's
        self._install(slot_idx, bt_row, c,
                      cow=(hit.pages[w], int(bt_row[w])) if cow else None)
        if cow:
            self._cow_copies.inc()
        if hit.pages[w:]:
            self._allocator.free(hit.pages[w:])  # refs not kept past copy
        self._slots[slot_idx] = self._new_slot(
            req, pages=list(hit.pages[:w]) + priv, tokens=[],
            last_token=int(req.prompt[c]), max_new=max_new,
            pending=[int(t) for t in req.prompt[c + 1:]], prefix_hit=True)
        self._count_admission(req.rid)
        self._prefix_hits.inc()
        self._prefix_hit_tokens.inc(c)
        submit_ts = self._submit_ts.get(req.rid)
        root = self._req_spans.get(req.rid)
        if root is not None and submit_ts is not None:
            now = time.perf_counter()
            self.tracer.record(
                "serve.queue_wait", submit_ts, t0,
                trace_id=root.trace_id, parent_id=root.span_id)
            self.tracer.record(
                "serve.prefix_install", t0, now,
                attrs={"covered": c, "suffix": plen - c, "cow": int(cow)},
                trace_id=root.trace_id, parent_id=root.span_id)
        self._update_occupancy()
        return True, []

    def _admit_cold(self, req: Request, slot_idx: int, plen: int,
                    max_new: int) -> tuple[bool, list[Completion]]:
        bs = self.cache_cfg.block_size
        n_pages = pages_for(plen + max_new + self._overrun_slack, bs)
        # a page-unaligned prompt that will be donated to the prefix
        # cache needs one spare page: the boundary page becomes shared at
        # insert, and this slot's own generation copy-on-writes it
        want_partial = (self._prefix is not None and plen >= bs
                        and plen % bs != 0)
        spare: list[int] | None = None
        pages = None
        if want_partial:
            got = self._alloc_with_evict(n_pages + 1)
            if got is not None:
                pages, spare = got[:n_pages], got[n_pages:]
        pre: list[Completion] = []
        if pages is None:
            pages, pre = self._alloc_preempting(req, n_pages)
        if pages is None:
            return False, pre  # wait for running sequences to free pages
        self._pending.popleft()
        adapter_row = self._req_adapter.get(req.rid, 0)
        bucket = self._bucket_for(plen)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :plen] = req.prompt
        bt_row = self._new_bt_row()
        bt_row[:len(pages)] = pages
        ids_t = torch.from_numpy(ids).to(self.device)
        bt_t = torch.from_numpy(bt_row).to(self.device)
        t_prefill = time.perf_counter()
        logits0 = self._prefill(ids_t, bt_t, slot_idx, plen,
                                adapter_row=adapter_row)
        tok = int(torch.argmax(logits0[plen - 1]))  # waits for the device
        if self._draft_model is not None:
            # same ids, same pages: the draft's K/V for this prompt lands
            # in the SAME page indices the target owns
            self._prefill(ids_t, bt_t, slot_idx, plen, draft=True)
        now = time.perf_counter()
        self._prefill_time += now - t_prefill
        self._prefill_count += 1
        self._count_admission(req.rid)
        if self._prefix is not None:
            self._prefix_misses.inc()
        submit_ts = self._submit_ts.pop(req.rid, None)
        if submit_ts is not None:
            # ONE clock reading closes both the histogram sample and the
            # trace: queue_wait + prefill spans sum to exactly the TTFT
            root = self._req_spans.get(req.rid)
            self._close_ttft(req.rid, now - submit_ts, root)
            if root is not None:
                self.tracer.record(
                    "serve.queue_wait", submit_ts, t_prefill,
                    trace_id=root.trace_id, parent_id=root.span_id)
                self.tracer.record(
                    "serve.prefill", t_prefill, now,
                    attrs={"bucket": bucket, "prompt_len": plen},
                    trace_id=root.trace_id, parent_id=root.span_id)
        if self.capture_logits:
            self.logit_log.setdefault(req.rid, []).append(
                logits0[plen - 1].float().cpu().numpy().copy())
        if self._audit_rate and adapter_row == 0:
            # adapter-carrying prefills skip the audit: the fp reference
            # runs the base model, so the LoRA delta would read as drift
            self._maybe_audit_quant(req.rid, ids_t, plen, logits0)
        slot = self._new_slot(req, pages=pages, tokens=[tok],
                              last_token=tok, max_new=max_new)
        self._slots[slot_idx] = slot
        self._emit_token(req.rid, tok)
        self._insert_prefix(slot_idx, slot, bt_row, plen, spare)
        done = self._finish_reason(slot, tok)
        if done:
            return True, pre + [self._release(slot_idx, done)]
        self._update_occupancy()
        return True, pre

    def _insert_prefix(self, slot_idx: int, slot: _Slot, bt_row: np.ndarray,
                       plen: int, spare: list[int] | None) -> None:
        """Donate a cold prompt's pages to the prefix cache. Prompts
        shorter than one page can never clear the hit gate, so they are
        not indexed."""
        bs = self.cache_cfg.block_size
        if self._prefix is None or plen < bs:
            if spare:
                self._allocator.free(spare)
            return
        m = pages_for(plen, bs)
        f = plen % bs
        if f and spare is None:
            # no spare to copy-on-write the boundary into: share the full
            # pages only
            self._prefix.insert(slot.req.prompt[:plen - f],
                                slot.pages[:m - 1])
            return
        self._prefix.insert(slot.req.prompt[:plen], slot.pages[:m])
        if not f:
            return
        boundary = slot.pages[m - 1]
        if not self._allocator.is_shared(boundary):
            # an equivalent boundary page was already cached; ours stayed
            # private and the spare goes back
            self._allocator.free(spare)
            return
        # the cache adopted the boundary page, and this slot writes
        # position plen into it next step: move the slot to a copy
        new = int(spare[0])
        bt_row = bt_row.copy()
        bt_row[m - 1] = new
        self._install(slot_idx, bt_row, plen, cow=(boundary, new))
        self._cow_copies.inc()
        slot.pages[m - 1] = new
        self._allocator.free([boundary])  # slot's ref; the cache keeps its

    def _maybe_audit_quant(self, rid: str, ids: torch.Tensor, plen: int,
                           logits0: torch.Tensor) -> None:
        """Quant-drift audit of a cold prefill: replay the padded prompt
        through the retained fp model (a full forward: the flash kernel
        on the card, counted as pass kind ``audit``) and compare the
        prompt rows' logits by :func:`~.quant.logit_gate`. Sampling is a
        deterministic rate accumulator, not an RNG: a rate of 0.5 audits
        exactly every second cold admission. The audit never fails the
        request it rides on; ``stats()["quant_audits"]`` counts the ones
        that completed, so a failing audit shows as a missing count."""
        self._audit_accum += self._audit_rate
        if self._audit_accum < 1.0:
            return
        self._audit_accum -= 1.0
        try:
            t0 = time.perf_counter()
            self._passes["audit"] += 1
            with torch.inference_mode():
                ref = self._audit_model(ids)[0, :plen]
            gate = quantlib.logit_gate(ref.float().cpu().numpy(),
                                       logits0[:plen].float().cpu().numpy())
            drift = float(gate["max_rel_err"])
        except Exception:  # noqa: BLE001 - telemetry never fails serving
            return
        self._drift_last = drift
        self._drift_max = max(self._drift_max, drift)
        self._quant_drift.set(drift)
        self._quant_audits.inc()
        root = self._req_spans.get(rid)
        if root is not None:
            self.tracer.record(
                "serve.quant_audit", t0, time.perf_counter(),
                attrs={"max_rel_err": drift,
                       "top1_agreement": float(gate["top1_agreement"])},
                trace_id=root.trace_id, parent_id=root.span_id)

    def register_adapter(self, name: str, a, b) -> int:
        """Install a LoRA adapter (``a [d_model, r]``, ``b [r, vocab]``,
        ``r <= lora_rank``) into the paged store; returns its row. The
        next pass gathers the new row from the stacks."""
        if self.adapters is None:
            raise ValueError("engine serves no adapters "
                             "(M2KT_SCHED_MAX_LORAS=0)")
        return self.adapters.register(name, a, b)

    def install_weights(self, state_dict, version: int | None = None) -> int:
        """Live weight swap: replace the parameters between steps without
        dropping in-flight requests; the next pass decodes with the new
        weights. ``state_dict`` maps the model's ``state_dict`` names to
        tensors or arrays: an fp tree (re-quantized under the engine's
        policy) or one already quantized (``*.q8``/``*.scale``). A tree
        whose names, shapes or dtypes differ from the resident one
        raises ``ValueError`` naming the offending shard, before
        anything is installed.

        The swap rebinds this engine's own modules to the new tensors
        (:func:`_rebind`); it never writes into the resident tensors,
        which it may share with the caller's model and with sibling
        engines built on it. Not safe concurrently with :meth:`step`:
        the fleet layer serializes it under the replica's step lock.
        Returns the installed version (``version`` for fleet-wide
        agreement, else the resident version + 1)."""
        fp_tree = {name: torch.as_tensor(t)
                   for name, t in state_dict.items()}
        tree = fp_tree
        if self.quant.quantize_weights:
            tree = _quantize_tree(self.model, fp_tree)
            if self._audit_rate and tree is fp_tree:
                raise ValueError(
                    "install_weights: the engine audits its quantized "
                    "weights against the fp checkpoint; pass the fp tree")
        _check_tree(self.model, tree)
        if self._audit_rate:
            # the drift auditor must reference the new checkpoint, or
            # every post-swap audit would report false drift
            _check_tree(self._audit_model, fp_tree)
            self._audit_model = _rebind(self._audit_model, fp_tree)
        self.model = _rebind(self.model, tree)
        if self.spec_k:
            # the draft is the target's own first blocks, embedding and
            # head: re-derive it so the proposer speaks the new weights
            self._draft_model = quantlib.draft_model_from(
                self.model, self._draft_cfg)
        if self._prefix is not None:
            # cached prefix K/V was computed under the old weights: drop
            # the cache (pages borrowed by in-flight slots survive until
            # those streams release them, the COW contract)
            self._prefix.clear()
            self._update_occupancy()
        self.weights_version = (int(version) if version is not None
                                else self.weights_version + 1)
        self._weights_version_gauge.set(self.weights_version)
        return self.weights_version

    def install_prefilled(self, req: Request, kvs, first_token: int,
                          prompt_len: int) -> tuple[bool, list[Completion]]:
        """Admit a request whose prefill ran elsewhere
        (:mod:`move2kube_tpu_torch.serving.fleet.disagg`): allocate
        pages, scatter the handed-off per-layer K/V into them (quantized
        under ``int8-kv``) and seat the slot with the prefill's first
        token; no local target prefill runs. ``kvs`` is the prefill's
        ``return_kv`` output, per layer ``(k, v)`` shaped ``[1, bucket,
        kv_heads, head_dim]`` (tensors or arrays, anywhere). Returns
        ``(installed, completions)``; not installed means no free slot
        or pages right now: retry after a :meth:`step`."""
        plen = int(prompt_len)
        max_new = req.max_new_tokens or self.config.max_new_tokens
        bucket = int(kvs[0][0].shape[1])
        tenant = slolib.clean_tenant(req.tenant)
        if self._draining:
            raise EngineDraining(f"{req.rid}: engine is draining")

        def reject(exc):
            self._rejected.inc()
            self._tenant_rejected.labels(tenant).inc()
            self.slo.record(tenant, ok=False)
            raise exc

        reason = self._deadline_verdict(req.deadline_s, max_new)
        if reason is not None:
            self._deadline_shed.labels(reason=reason).inc()
            reject(DeadlineExceeded(
                f"{req.rid}: handoff deadline {req.deadline_s:.3f}s "
                f"{reason} for {max_new} new tokens"))
        if (plen < 1 or plen + max_new + self._overrun_slack
                > self.cache_cfg.max_seq):
            reject(ValueError(
                f"{req.rid}: handoff of {plen} prompt + {max_new} new "
                f"tokens does not fit max_seq {self.cache_cfg.max_seq}"))
        if req.adapter:
            # the handoff carries only base-model K/V and a first token
            # the prefill replica argmaxed without the adapter's delta:
            # admitting it would serve the wrong head
            reject(ValueError(f"{req.rid}: disagg handoff does not carry "
                              f"adapter state (adapter {req.adapter!r})"))
        if bucket > self.cache_cfg.max_seq:
            reject(ValueError(f"{req.rid}: handoff bucket {bucket} exceeds "
                              f"max_seq {self.cache_cfg.max_seq}"))
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return False, []
        pages = self._alloc_with_evict(pages_for(
            plen + max_new + self._overrun_slack, self.cache_cfg.block_size))
        if pages is None:
            return False, []
        slot_idx = free[0]
        t_install = time.perf_counter()
        bt_row = self._new_bt_row()
        bt_row[:len(pages)] = pages
        bt_t = torch.from_numpy(bt_row).to(self.device)
        with torch.inference_mode():
            kv_dev = [(torch.as_tensor(k).to(self.device),
                       torch.as_tensor(v).to(self.device)) for k, v in kvs]
            scatter_prefill(self._cache, kv_dev, slot_idx, bt_t, plen,
                            self.cache_cfg.block_size)
        del kv_dev
        if self._draft_model is not None:
            # the handoff carries only the target's K/V; the draft's comes
            # from a local draft prefill over the same prompt
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :plen] = req.prompt[:plen]
            self._prefill(torch.from_numpy(ids).to(self.device), bt_t,
                          slot_idx, plen, draft=True)
        self._count_admission_tenant(tenant)
        self._req_tenant[req.rid] = tenant
        # availability counts the seat; TTFT closed on the prefill side,
        # where the request's submit clock lives
        self.slo.record(tenant, ok=True)
        if self.tracer is not None and req.rid not in self._req_spans:
            # the decode replica opens its own root for the handed-off
            # request; remote_parent stitches it under the router's span
            root = self.tracer.start(
                "serve.request",
                attrs={"rid": req.rid, "prompt_len": plen,
                       "tenant": tenant, "disagg": 1},
                detached=True, remote_parent=req.traceparent or None)
            self._req_spans[req.rid] = root
            self.tracer.record(
                "serve.kv_install", t_install, time.perf_counter(),
                attrs={"bucket": bucket, "prompt_len": plen},
                trace_id=root.trace_id, parent_id=root.span_id)
        tok = int(first_token)
        slot = self._new_slot(req, pages=pages, tokens=[tok],
                              last_token=tok, max_new=max_new)
        self._slots[slot_idx] = slot
        self._emit_token(req.rid, tok)
        self._update_occupancy()
        done = self._finish_reason(slot, tok)
        if done:
            return True, [self._release(slot_idx, done)]
        return True, []

    @torch.inference_mode()
    def _cost_prefill(self, ids: torch.Tensor):
        """The prefill's model pass of :meth:`_prefill` (the base adapter
        row under LoRA), without the scatter into the slot's pages."""
        return self.model(ids, return_kv=True,
                          lora=self._lora_args(rows=[0]))

    @torch.inference_mode()
    def _cost_passes(self, cache: dict, n: int):
        """``n`` single-token passes of every row at positions ``0..n-1``
        over ``cache`` (one decode step, or a verify window's passes)."""
        B = self.config.max_batch
        tokens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        pos = torch.zeros((B,), dtype=torch.int32, device=self.device)
        lora = self._lora_args(rows=[0] * B)
        for j in range(n):
            self._pass(self.model, cache, tokens, pos + j,
                       cache["block_tables"], lora)

    def cost_report(self, accelerator: str = "") -> dict:
        """Roofline/MFU cost model of every bucketed pass
        (:mod:`move2kube_tpu_torch.obs.costmodel`): each prefill bucket,
        the decode step and, with spec on, the verify window are each run
        once under the counters on zero-filled inputs, and the serving
        gauges (``m2kt_serve_roofline_bound{executable=...}`` etc.) are set
        on this engine's registry. Decode MFU uses the engine's own
        measured per-step decode time when any decode has run.

        The reference lowers its executables without running them; the
        port has to run a pass to count it, so the passes leave the engine
        as they found it: the prefills write no page, and the single-token
        passes write into scratch pools of one page with the live cache's
        geometry. The live pools (the null page included), ``seq_lens``,
        the page allocator, ``stats()["passes"]``, the streams in flight
        and every metric but the cost gauges are untouched. The passes do
        launch the kernels (one flash forward a layer a bucket, one paged
        decode a layer a single-token pass), and on the card they reset
        the device's peak-memory statistics."""
        from move2kube_tpu_torch.obs import costmodel

        reports: dict = {}
        for bucket in self.buckets:
            ids = torch.zeros((1, bucket), dtype=torch.long,
                              device=self.device)
            _, reports[f"prefill_{bucket}"] = costmodel.count_cost(
                self._cost_prefill, ids, device=self.device)
        scratch = init_cache(dataclasses.replace(self.cache_cfg, num_pages=1),
                             self.device)
        _, decode = costmodel.count_cost(self._cost_passes, scratch, 1,
                                         device=self.device)
        reports["decode"] = decode
        # decode is the steady-state resident: its memory is what the OOM
        # flight sidecar should carry for a serving pod
        costmodel.note_memory_report(decode)
        if self.spec_k:
            _, verify = costmodel.count_cost(
                self._cost_passes, scratch, self.spec_k + 1,
                device=self.device)
            reports["verify"] = verify
            costmodel.note_memory_report(verify)
        spec, _ = costmodel.chip_spec(accelerator)
        decode_step = (self._decode_time / self._lat_hist.count
                       if self._lat_hist.count else None)
        costmodel.export_serving_gauges(
            reports, self.registry, accelerator=accelerator,
            decode_step_seconds=decode_step, quant=self.quant.name)
        out = {}
        for name, rep in reports.items():
            entry = rep.to_dict()
            entry["roofline"] = rep.roofline(spec)
            out[name] = entry
        int8 = self.quant.name != "off"
        for name in ("decode", "verify"):
            if name in out:
                out[name]["achieved_mfu"] = reports[name].mfu(
                    decode_step, spec, int8=int8)
        return out

    def stats(self) -> dict:
        """Counters of this engine's work so far. Host-clock times end in
        a read of the step's result, so they include the device's work.
        Percentiles come from the fixed-bucket histograms (bucket-edge
        interpolation). ``passes`` counts the model passes by kind
        (``PASS_KINDS``): each runs one attention kernel per layer of its
        model (the draft's layers for the ``draft_*`` kinds)."""
        lat_n = self._lat_hist.count
        ttft_n = self._ttft_hist.count
        gaps = self._gap_total + self._busy_total
        out = {
            "device": str(self.device),
            "decode_steps": self._decode_steps,
            "decode_tokens": self._decode_tokens,
            "decode_time_s": self._decode_time,
            "decode_throughput_tokens_s": (
                self._decode_tokens / self._decode_time
                if self._decode_time else 0.0),
            "prefills": self._prefill_count,
            "prefill_time_s": self._prefill_time,
            "ttft_mean_ms": (self._ttft_hist.sum / ttft_n * 1e3
                             if ttft_n else 0.0),
            "ttft_max_ms": self._ttft_max * 1e3,
            "decode_p50_latency_ms": self._lat_hist.quantile(0.50) * 1e3,
            "decode_p95_latency_ms": self._lat_hist.quantile(0.95) * 1e3,
            "queue_depth": len(self._pending),
            "active_slots": sum(1 for s in self._slots if s is not None),
            "ttft_p50_ms": self._ttft_hist.quantile(0.50) * 1e3,
            "ttft_p95_ms": self._ttft_hist.quantile(0.95) * 1e3,
            # the port runs the synchronous loop only (no async pipeline)
            "async_decode": False,
            "dispatch_gap_p50_ms": self._dispatch_gap.quantile(0.50) * 1e3,
            "dispatch_gap_total_s": self._gap_total,
            "host_overhead_ratio": (self._gap_total / gaps if gaps > 0
                                    else 0.0),
            "passes": dict(self._passes),
        }
        if self._prefix is not None:
            hits = self._prefix_hits.value
            misses = self._prefix_misses.value
            out["prefix_hits"] = int(hits)
            out["prefix_misses"] = int(misses)
            out["prefix_hit_rate"] = (hits / (hits + misses)
                                      if hits + misses else 0.0)
            out["prefix_hit_tokens"] = int(self._prefix_hit_tokens.value)
            out["prefix_cache_pages"] = self._prefix.total_pages
            out["cow_copies"] = int(self._cow_copies.value)
        if self._audit_rate:
            out["quant_audits"] = int(self._quant_audits.value)
            out["quant_drift_last_rel"] = self._drift_last
            out["quant_drift_max_rel"] = self._drift_max
        if self._preempt_enabled:
            out["preempted"] = self._preempt_count
        if self.chunk_prefill:
            out["chunked_prefills"] = self._chunk_count
        if self.adapters is not None:
            out["lora_adapters"] = len(self.adapters.names)
        if self.spec_k:
            prop = self._spec_proposed.value
            acc = self._spec_accepted.value
            out["spec_proposed"] = int(prop)
            out["spec_accepted"] = int(acc)
            out["spec_acceptance_rate"] = acc / prop if prop else 0.0
            # tokens landed per verify step: 1.0 is plain decode
            out["spec_tokens_per_step"] = (
                self._decode_tokens / lat_n if lat_n else 0.0)
        return out


def _check_tree(model, tree: dict) -> None:
    """Raise ``ValueError`` unless ``tree`` has exactly ``model``'s
    ``state_dict`` names, each with the resident shape and dtype."""
    resident = model.state_dict()
    if set(resident) != set(tree):
        missing = sorted(set(resident) - set(tree))[:3]
        extra = sorted(set(tree) - set(resident))[:3]
        raise ValueError(f"install_weights: parameter tree mismatch: "
                         f"missing {missing}, unexpected {extra}")
    for name in sorted(resident):
        old, new = resident[name], tree[name]
        if old.shape != new.shape or old.dtype != new.dtype:
            raise ValueError(
                f"install_weights: shard {name!r} is {new.dtype}"
                f"{list(new.shape)}; the resident weights are "
                f"{old.dtype}{list(old.shape)}")


def _quantize_tree(qmodel, tree: dict) -> dict:
    """An fp ``state_dict`` in ``qmodel``'s quantized layout: each
    ``<layer>.weight`` whose layer is a :class:`~.quant.QuantLinear`
    becomes ``<layer>.q8`` and ``<layer>.scale`` (quantized where it
    lies, by :func:`~.quant.quantize_array`). An already-quantized tree
    is returned as it is."""
    qnames = {name for name, mod in qmodel.named_modules()
              if isinstance(mod, quantlib.QuantLinear)}
    if not any(f"{name}.weight" in tree for name in qnames):
        return tree
    out = {}
    for key, t in tree.items():
        layer, _, leaf = key.rpartition(".")
        if leaf == "weight" and layer in qnames:
            out[f"{layer}.q8"], out[f"{layer}.scale"] = (
                quantlib.quantize_array(t))
        else:
            out[key] = t
    return out


def _rebind(model, tree: dict):
    """A copy of ``model`` whose parameters and buffers are ``tree``'s
    tensors (moved to where the resident ones lie; no copy when they are
    there already), the module structure duplicated and no resident
    tensor written. Engines that share the original model keep it."""
    memo = {}
    for name, old in model.state_dict(keep_vars=True).items():
        new = tree[name].to(old.device)
        memo[id(old)] = (torch.nn.Parameter(new, requires_grad=False)
                         if isinstance(old, torch.nn.Parameter) else new)
    return copy.deepcopy(model, memo)
