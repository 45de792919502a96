"""Continuous-batching greedy decode engine over the paged KV cache: the
synchronous, cold-prefill core of ``move2kube_tpu/serving/engine.py``.

Sequences are admitted into free decode slots mid-flight (up to
``admit_burst`` prefills per step, so running sequences never stall
behind an admission burst) and release their slot and pages the step
they finish. A prompt prefills padded to the smallest configured bucket
that fits; every decode step runs all ``max_batch`` rows, with idle rows
redirected at the null page (:func:`~.kvcache.sanitized_views`).

The engine runs eagerly under ``torch.inference_mode()`` on the model's
device: on the card, prefill attention is the flash kernel (with
``attn_impl="flash"``) and every decode step's attention is the
paged-decode kernel (``csrc/paged_decode_int8.cu`` on an int8 cache).

Low-precision serving (``quant``, :mod:`.quant`): the engine quantizes
the model's weights once, at construction (per-output-channel int8,
dequantized inside each step), and keeps only the quantized copy;
``int8-kv`` also stores the paged KV cache as int8 rows with per-row
scales. Not ported yet (ROADMAP.md, Queue 1): the async decode pipeline,
speculative decoding, the prefix cache, the quant-drift audit, LoRA, the
scheduler plane, chunked prefill, CUDA graphs and the metrics registry /
tracing hooks.

Env knobs (the JAX engine's names):

- ``M2KT_SERVE_MAX_BATCH``  concurrent decode slots   (default 8)
- ``M2KT_SERVE_MAX_SEQ``    max context per sequence  (default 256)
- ``M2KT_KV_BLOCK_SIZE``    tokens per KV-cache page  (default 16)
- ``M2KT_SERVE_BUCKETS``    prefill buckets, comma-sep (default: powers
  of two from 32 up to max_seq)
- ``M2KT_SERVE_ADMIT_BURST`` admissions per step; <= 0 = all free slots
  (default 1)
- ``M2KT_SERVE_QUANT``      serving quant policy off|int8|int8-kv
  (default off; an unknown name means off)
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.serving import quant as quantlib
from move2kube_tpu_torch.serving.kvcache import (
    NULL_PAGE,
    PAGE_KEYS,
    PageAllocator,
    init_cache,
    pages_for,
    sanitized_views,
    scatter_prefill,
    spec_for_model,
)


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
    quant: str = "off"         # off | int8 | int8-kv (serving/quant.py)

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
            quant=(lambda q: q if q in quantlib.QUANT_OPTIONS else "off")(
                os.environ.get("M2KT_SERVE_QUANT", "") or cls.quant),
        )
        cfg.update(overrides)
        return cls(**cfg)


@dataclasses.dataclass
class Request:
    rid: str
    prompt: list[int]
    max_new_tokens: int | None = None


@dataclasses.dataclass
class Completion:
    rid: str
    prompt_len: int
    tokens: list[int]
    finish_reason: str  # "eos" | "length"


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list[int]
    tokens: list[int]
    last_token: int
    max_new: int


class ServingEngine:
    """Greedy-decoding continuous-batching engine for the port's ``Llama``
    (anything whose ``forward`` carries the prefill and paged-decode
    modes). The KV cache lives on ``device`` (the card by default), which
    must be where the model's parameters are. Under a quant policy that
    quantizes weights, ``self.model`` is the engine's quantized copy
    (:func:`~.quant.quantize_model`); the caller's model is not kept."""

    def __init__(self, model, config: EngineConfig | None = None, *,
                 device=None) -> None:
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(f"model parameters are on {model_dev}, the "
                             f"engine's device is {self.device}")
        self.config = config or EngineConfig.from_env()
        self.quant = quantlib.policy(self.config.quant)
        if self.quant.quantize_weights:
            model = quantlib.quantize_model(model)
        self.model = model
        self.buckets = self.config.resolved_buckets()
        self.cache_cfg = spec_for_model(
            model.cfg, block_size=self.config.block_size,
            max_batch=self.config.max_batch, max_seq=self.config.max_seq,
            cache_dtype=self.quant.cache_dtype)
        self._cache = init_cache(self.cache_cfg, model_dev)
        self._allocator = PageAllocator(self.cache_cfg.num_pages)
        self._slots: list[_Slot | None] = [None] * self.config.max_batch
        self._pending: deque[Request] = deque()
        # opt-in logit capture for the equivalence checks: per-rid rows of
        # the logits each *generated* token was argmaxed from
        self.capture_logits = False
        self.logit_log: dict[str, list[np.ndarray]] = {}
        # token-emission hook: called ``on_token(rid, token)`` the moment
        # a generated token lands in its slot (prefill's first token and
        # every decode step)
        self.on_token = None
        self._decode_time = 0.0
        self._decode_tokens = 0
        self._decode_steps = 0
        self._prefill_count = 0
        self._prefill_time = 0.0
        self._ttft_sum = 0.0
        self._ttft_max = 0.0
        self._ttft_count = 0
        self._submit_ts: dict[str, float] = {}

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, ids: torch.Tensor, bt_row: torch.Tensor,
                 slot: int, plen: int):
        logits, kvs = self.model(ids, return_kv=True)
        scatter_prefill(self._cache, kvs, slot, bt_row, plen,
                        self.cache_cfg.block_size)
        first = int(torch.argmax(logits[0, plen - 1]))
        return first, logits[0]

    @torch.inference_mode()
    def _decode(self, tokens: torch.Tensor, active: torch.Tensor):
        cache = self._cache
        # sanitize freed/idle slots: their stale tables must not write
        # into pages the allocator may have handed to someone else
        bt, pos = sanitized_views(cache, active)
        model_cache = {k: cache[k] for k in PAGE_KEYS if k in cache}
        model_cache["block_tables"] = bt
        model_cache["seq_lens"] = pos + 1
        logits, _ = self.model(tokens, positions=pos, cache=model_cache)
        cache["seq_lens"] += active.to(torch.int32)
        next_tokens = torch.argmax(logits, dim=-1)
        return logits, next_tokens

    # ------------------------------------------------------------------
    # host-side continuous batching
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        max_new = req.max_new_tokens or self.config.max_new_tokens
        if plen < 1:
            raise ValueError(f"{req.rid}: empty prompt")
        if plen > self.buckets[-1]:
            raise ValueError(
                f"{req.rid}: prompt length {plen} exceeds the largest "
                f"prefill bucket {self.buckets[-1]}")
        if plen + max_new > self.cache_cfg.max_seq:
            raise ValueError(
                f"{req.rid}: prompt + max_new_tokens = {plen + max_new} "
                f"exceeds max_seq {self.cache_cfg.max_seq}")
        self._submit_ts[req.rid] = time.perf_counter()
        self._pending.append(req)

    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    def _emit_token(self, rid: str, tok: int) -> None:
        cb = self.on_token
        if cb is not None:
            cb(rid, tok)

    def step(self) -> list[Completion]:
        """One engine iteration: admit pending requests into free slots
        (up to ``admit_burst`` bucketed prefills), then run one decode
        step for every active slot. Returns the sequences that finished
        this iteration."""
        finished = self._admit_pending()
        active = [s is not None for s in self._slots]
        if not any(active):
            return finished
        tokens = torch.tensor(
            [s.last_token if s is not None else 0 for s in self._slots],
            dtype=torch.int32, device=self.device)
        active_mask = torch.tensor(active, device=self.device)
        t0 = time.perf_counter()
        logits, next_tokens = self._decode(tokens, active_mask)
        next_tokens = next_tokens.cpu().numpy()  # waits for the step
        dt = time.perf_counter() - t0
        produced = sum(active)
        self._decode_time += dt
        self._decode_tokens += produced
        self._decode_steps += 1
        logits_np = (logits.float().cpu().numpy() if self.capture_logits
                     else None)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            tok = int(next_tokens[i])
            if logits_np is not None:
                self.logit_log.setdefault(slot.req.rid, []).append(
                    logits_np[i].copy())
            slot.tokens.append(tok)
            slot.last_token = tok
            self._emit_token(slot.req.rid, tok)
            done = self._finish_reason(slot, tok)
            if done:
                finished.append(self._release(i, done))
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
        self._allocator.free(slot.pages)
        self._slots[slot_idx] = None
        self._submit_ts.pop(slot.req.rid, None)
        return Completion(rid=slot.req.rid, prompt_len=len(slot.req.prompt),
                          tokens=list(slot.tokens), finish_reason=reason)

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
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return False, []
        req = self._pending[0]
        plen = len(req.prompt)
        max_new = req.max_new_tokens or self.config.max_new_tokens
        return self._admit_cold(req, free[0], plen, max_new)

    def _admit_cold(self, req: Request, slot_idx: int, plen: int,
                    max_new: int) -> tuple[bool, list[Completion]]:
        bs = self.cache_cfg.block_size
        pages = self._allocator.alloc(pages_for(plen + max_new, bs))
        if pages is None:
            return False, []  # wait for running sequences to free pages
        self._pending.popleft()
        bucket = self._bucket_for(plen)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :plen] = req.prompt
        bt_row = np.full((self.cache_cfg.max_pages_per_seq,), NULL_PAGE,
                         np.int32)
        bt_row[:len(pages)] = pages
        t_prefill = time.perf_counter()
        tok, logits0 = self._prefill(
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(bt_row).to(self.device), slot_idx, plen)
        now = time.perf_counter()  # the argmax above waited for the device
        self._prefill_time += now - t_prefill
        self._prefill_count += 1
        submit_ts = self._submit_ts.pop(req.rid, None)
        if submit_ts is not None:
            ttft = now - submit_ts
            self._ttft_sum += ttft
            self._ttft_max = max(self._ttft_max, ttft)
            self._ttft_count += 1
        if self.capture_logits:
            self.logit_log.setdefault(req.rid, []).append(
                logits0[plen - 1].float().cpu().numpy().copy())
        slot = _Slot(req=req, pages=pages, tokens=[tok], last_token=tok,
                     max_new=max_new)
        self._slots[slot_idx] = slot
        self._emit_token(req.rid, tok)
        done = self._finish_reason(slot, tok)
        if done:
            return True, [self._release(slot_idx, done)]
        return True, []

    def stats(self) -> dict:
        """Host-clock counters of this engine's work so far. Decode and
        prefill times end in a read of the step's result, so they include
        the device's work."""
        return {
            "device": str(self.device),
            "decode_steps": self._decode_steps,
            "decode_tokens": self._decode_tokens,
            "decode_time_s": self._decode_time,
            "decode_throughput_tokens_s": (
                self._decode_tokens / self._decode_time
                if self._decode_time else 0.0),
            "prefills": self._prefill_count,
            "prefill_time_s": self._prefill_time,
            "ttft_mean_ms": (self._ttft_sum / self._ttft_count * 1e3
                             if self._ttft_count else 0.0),
            "ttft_max_ms": self._ttft_max * 1e3,
        }
