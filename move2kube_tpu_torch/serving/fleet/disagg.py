"""Disaggregated prefill/decode of the port: dedicated prefill replicas
hand finished K/V to decode replicas (the port's own copy of
``move2kube_tpu/serving/fleet/disagg.py``).

One engine runs a bucketed prefill between its decode steps, so a long
prompt stalls every running stream for a whole prefill. Disaggregation
moves prefill onto its own replicas: a :class:`PrefillReplica` runs the
model's ``return_kv`` forward (the flash kernel on the card; no paged
cache, no decode slots) and ships the per-layer K/V as a
:class:`KVHandoff`; the decode engine seats it with
:meth:`~move2kube_tpu_torch.serving.engine.ServingEngine.install_prefilled`,
one scatter into its pages and no local prefill.

The wire is the JAX package's, byte for byte: the same npz members, meta
keys and wire version, so an fp32 handoff crosses the two frameworks in
either direction. numpy has no bfloat16: bf16 K/V travel as their raw
2-byte words, dtype ``|V2``, which is what ``np.savez`` writes for the
JAX package's ``ml_dtypes.bfloat16`` arrays; the port reads ``|V2`` back
as bf16. The K/V leave the card only for the wire (:meth:`KVHandoff.to_bytes`).
"""

from __future__ import annotations

import dataclasses
import io
import json
import time

import numpy as np
import torch

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.obs import tracing
from move2kube_tpu_torch.obs.metrics import Registry
from move2kube_tpu_torch.serving import quant as quantlib
from move2kube_tpu_torch.serving.engine import (
    PASS_KINDS,
    Completion,
    EngineConfig,
    Request,
)
from move2kube_tpu_torch.serving.fleet.weights import from_wire, to_wire

_WIRE_VERSION = 1


@dataclasses.dataclass
class KVHandoff:
    """A finished prefill, ready to decode anywhere: the prompt, the
    per-layer K/V padded to the prefill bucket (tensors, on the card
    until the wire), and the first generated token (the prefill's logits
    already paid for it)."""

    rid: str
    prompt: list[int]
    prompt_len: int
    bucket: int
    first_token: int
    kv: list  # per layer (k, v), each [1, bucket, kv_heads, head_dim]
    max_new_tokens: int | None = None
    # fleet attribution rides the handoff: the tenant and the router's
    # span traceparent, so the decode replica's serve.request stitches
    # into the trace the router opened
    tenant: str = ""
    traceparent: str = ""

    def to_bytes(self) -> bytes:
        meta = {
            "v": _WIRE_VERSION, "rid": self.rid,
            "prompt_len": self.prompt_len, "bucket": self.bucket,
            "first_token": self.first_token,
            "max_new_tokens": self.max_new_tokens,
            "tenant": self.tenant, "traceparent": self.traceparent,
        }
        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            prompt=np.asarray(self.prompt, np.int32),
            k=to_wire(_stack([k for k, _ in self.kv])),
            v=to_wire(_stack([v for _, v in self.kv])))
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVHandoff":
        """Parse a wire handoff. Every malformation (a truncated or
        garbage npz, missing arrays or keys, undecodable meta) surfaces
        as ``ValueError``, so the ingesting replica refuses it cleanly
        instead of crashing its worker thread."""
        try:
            with np.load(io.BytesIO(data), allow_pickle=False) as z:
                meta = json.loads(z["meta"].tobytes().decode())
                if meta.get("v") != _WIRE_VERSION:
                    raise ValueError(
                        f"KV handoff wire version {meta.get('v')!r}; "
                        f"this replica speaks {_WIRE_VERSION}")
                ks, vs = from_wire(z["k"]), from_wire(z["v"])
                return cls(
                    rid=str(meta["rid"]),
                    prompt=[int(t) for t in z["prompt"]],
                    prompt_len=int(meta["prompt_len"]),
                    bucket=int(meta["bucket"]),
                    first_token=int(meta["first_token"]),
                    kv=[(ks[i], vs[i]) for i in range(ks.shape[0])],
                    max_new_tokens=meta["max_new_tokens"],
                    # older peers' handoffs lack the attribution keys
                    tenant=str(meta.get("tenant", "") or ""),
                    traceparent=str(meta.get("traceparent", "") or ""))
        except ValueError:
            raise
        except Exception as err:  # noqa: BLE001 - BadZipFile, KeyError, ...
            raise ValueError(f"malformed KV handoff: "
                             f"{type(err).__name__}: {err}") from err

    def request(self) -> Request:
        return Request(rid=self.rid, prompt=list(self.prompt),
                       max_new_tokens=self.max_new_tokens,
                       tenant=self.tenant, traceparent=self.traceparent)


def _stack(leaves):
    if all(isinstance(t, torch.Tensor) for t in leaves):
        return torch.stack(leaves)
    return np.stack([to_wire(t) for t in leaves])


class PrefillReplica:
    """Prefill-only worker: the engine's bucketing, no paged cache and no
    decode step; its whole job is turning prompts into handoffs. Under a
    weight-quantizing policy it runs the same int8 weights a decode
    engine would (:func:`~move2kube_tpu_torch.serving.quant.quantize_model`);
    the handoff K/V stay in the compute type, and an ``int8-kv`` decode
    engine quantizes them into its own pages."""

    def __init__(self, model, config: EngineConfig | None = None, *,
                 device=None, registry: Registry | None = None,
                 tracer=None) -> None:
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model parameters are on {model_dev}, the "
                             f"prefill replica's device is {self.device}")
        self.tracer = tracer if tracer is not None else (
            tracing.get() if tracing.enabled() else None)
        self.config = config or EngineConfig.from_env()
        policy = quantlib.policy(self.config.quant)
        if policy.quantize_weights:
            model = quantlib.quantize_model(model)
        self.model = model
        self.buckets = self.config.resolved_buckets()
        self.registry = registry if registry is not None else Registry()
        self._prefills = self.registry.counter(
            "m2kt_disagg_prefills_total", "Prompts prefilled for handoff")
        self._prefill_time = self.registry.counter(
            "m2kt_disagg_prefill_seconds_total",
            "Wall time spent in prefill forwards")
        # model passes by kind, as the engine counts them: each prefill
        # runs the flash kernel once a layer on the card
        self._passes = dict.fromkeys(PASS_KINDS, 0)

    def _bucket_for(self, plen: int) -> int:
        for b in self.buckets:
            if plen <= b:
                return b
        raise ValueError(f"no bucket fits prompt length {plen}")

    def prefill(self, req: Request) -> KVHandoff:
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"{req.rid}: empty prompt")
        bucket = self._bucket_for(plen)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :plen] = req.prompt
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._passes["prefill"] += 1
            logits, kvs = self.model(torch.from_numpy(ids).to(self.device),
                                     return_kv=True)
            first = int(torch.argmax(logits[0, plen - 1]))  # waits
        t1 = time.perf_counter()
        self._prefill_time.inc(t1 - t0)
        self._prefills.inc()
        if self.tracer is not None:
            # record() keeps the forward's own clock readings; the remote
            # parent (the router's call span) is resolved by hand
            remote = tracing.parse_traceparent(req.traceparent or None)
            self.tracer.record(
                "prefill.request", t0, t1,
                attrs={"rid": req.rid, "prompt_len": plen, "bucket": bucket,
                       "tenant": req.tenant or "default"},
                trace_id=remote[0] if remote else None,
                parent_id=remote[1] if remote else "")
        return KVHandoff(
            rid=req.rid, prompt=list(req.prompt), prompt_len=plen,
            bucket=bucket, first_token=first, kv=list(kvs),
            max_new_tokens=req.max_new_tokens,
            tenant=req.tenant, traceparent=req.traceparent)

    def stats(self) -> dict:
        """``prefills``, ``prefill_time_s`` and ``passes`` (the engine's
        pass kinds; only ``prefill`` moves here)."""
        return {"prefills": int(self._prefills.value),
                "prefill_time_s": float(self._prefill_time.value),
                "passes": dict(self._passes)}


class KVTransport:
    """The prefill->decode seam. ``send`` delivers one handoff to the
    decode side; implementations decide the medium (in-process list,
    HTTP POST of ``to_bytes()``)."""

    def send(self, handoff: KVHandoff) -> None:
        raise NotImplementedError


class InProcessTransport(KVTransport):
    """Same-process delivery that still exercises the wire format: every
    handoff round-trips through ``to_bytes``/``from_bytes``."""

    def __init__(self) -> None:
        self.inbox: list[KVHandoff] = []

    def send(self, handoff: KVHandoff) -> None:
        self.inbox.append(KVHandoff.from_bytes(handoff.to_bytes()))


class DisaggPair:
    """One prefill replica feeding one decode engine: the smallest
    disaggregated deployment."""

    def __init__(self, prefill: PrefillReplica, engine,
                 transport: KVTransport | None = None):
        self.prefill_replica = prefill
        self.engine = engine
        self.transport = transport or InProcessTransport()

    def run(self, requests) -> list[Completion]:
        for req in requests:
            self.transport.send(self.prefill_replica.prefill(req))
        inbox = getattr(self.transport, "inbox", None)
        if inbox is None:
            raise TypeError("DisaggPair.run needs a transport with an inbox")
        completions: list[Completion] = []
        while inbox or self.engine.has_work():
            while inbox:
                h = inbox[0]
                ok, done = self.engine.install_prefilled(
                    h.request(), h.kv, h.first_token, h.prompt_len)
                completions.extend(done)
                if not ok:
                    break  # no slot or pages free: decode a step, retry
                inbox.pop(0)
            completions.extend(self.engine.step())
        return completions
