"""Fleet trace collector: stitch per-role span rings into one timeline,
the port's own copy of ``move2kube_tpu/obs/fleetview.py``.

Each fleet process (router, prefill, decode) keeps its own bounded span
ring and serves it at ``/traces`` (:mod:`.server`) in the flight-recorder
document shape. This module pulls those rings (over HTTP, from live
``SpanRecorder`` objects, or from already-parsed docs) and merges them
into one cross-process view, keyed by the W3C trace ids the router
propagated on every hop.

Network-gap synthesis, and why the decomposition is exact: process
clocks are not synchronized, so absolute cross-host timestamps cannot be
trusted, but differences of the SAME parent/child pair's endpoints can.
For every cross-process edge (a replica span whose parent span lives in
another process) the collector synthesizes two ``net.hop`` spans as
residuals of the client span around the server span:

    hop_send = server.start - client.start
    hop_recv = client.end   - server.end

so ``client.dur == hop_send + server.dur + hop_recv`` holds to float
rounding by construction, whatever the skew (skew shifts the two gaps in
opposite directions; their sum is skew-free). Likewise router-local idle
between a parent's consecutive child spans becomes ``local.gap`` spans,
so the router-observed e2e equals the sum of its decomposed parts, and
``decompose()`` reports the residual.

Stdlib-only (urllib for the pulls).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

SYNTH_HOP = "net.hop"
SYNTH_GAP = "local.gap"


def _src_key(span: dict) -> tuple:
    # role is part of the identity: in-process fleets run router and
    # replica recorders under one pid
    return (span.get("host", ""), span.get("pid", 0), span.get("role", ""))


class FleetTraceCollector:
    """Pulls span rings from fleet roles and stitches one timeline.

    Sources may be mixed:

    - ``str`` — base URL of a role's telemetry server; pulled from
      ``<url>/traces`` (append ``clear`` at collect time to drain);
    - objects with ``ring_doc()`` — live in-process recorders;
    - ``dict`` — an already-parsed ring document (e.g. a flight file).

    A source that fails to answer is skipped, not raised: the collector
    runs against fleets where replicas die — that is the point.
    """

    def __init__(self, sources=(), timeout_s: float = 2.0) -> None:
        self.sources = list(sources)
        self.timeout_s = timeout_s

    def add_source(self, source) -> None:
        self.sources.append(source)

    # -- collection --------------------------------------------------------

    def _pull(self, source, clear: bool) -> dict | None:
        if isinstance(source, dict):
            return source
        ring_doc = getattr(source, "ring_doc", None)
        if callable(ring_doc):
            return ring_doc()
        url = str(source).rstrip("/") + "/traces"
        if clear:
            url += "?clear=1"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode("utf-8"))
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def collect(self, clear: bool = False) -> list[dict]:
        docs = []
        for source in self.sources:
            doc = self._pull(source, clear)
            if doc and isinstance(doc.get("spans"), list):
                docs.append(doc)
        return docs

    # -- stitching ---------------------------------------------------------

    def stitch(self, docs: list[dict] | None = None) -> dict:
        """Merge ring docs into ``{"spans": [...], "traces": {tid: [...]}}``
        with per-hop ``net.hop`` spans synthesized on every cross-process
        parent/child edge. Every span gains ``host``/``pid``/``role``
        from its source doc and a ``synthetic`` flag."""
        if docs is None:
            docs = self.collect()
        spans: list[dict] = []
        by_id: dict[str, dict] = {}
        for doc in docs:
            for s in doc.get("spans", []):
                t = dict(s)
                t.setdefault("host", doc.get("host", ""))
                t["pid"] = doc.get("pid", 0)
                t["role"] = s.get("role") or doc.get("role", "")
                t["synthetic"] = False
                spans.append(t)
                by_id[t["span_id"]] = t
        synth: list[dict] = []
        for s in spans:
            parent = by_id.get(s.get("parent_id", ""))
            if parent is None or _src_key(parent) == _src_key(s):
                continue
            synth.extend(self._hops(parent, s))
        spans = spans + synth
        traces: dict[str, list[dict]] = {}
        for s in spans:
            traces.setdefault(s["trace_id"], []).append(s)
        for tid in traces:
            traces[tid].sort(key=lambda x: x["ts_unix"])
        return {"spans": spans, "traces": traces}

    @staticmethod
    def _hops(client: dict, server: dict) -> list[dict]:
        """The two residual gap spans around one cross-process edge.
        Durations may come out negative under extreme skew — they are
        residuals, and keeping them is what keeps the sum exact."""
        c0 = client["ts_unix"]
        s0 = server["ts_unix"]
        # send is the one genuine cross-clock difference; recv is the
        # residual closing the client span, computed as small-number
        # arithmetic (NOT as a difference of epoch-anchored endpoints,
        # whose float ulp is ~0.5µs) so send + server + recv equals the
        # client duration to float rounding
        send = s0 - c0
        recv = client["dur_s"] - server["dur_s"] - send
        common = {
            "trace_id": client["trace_id"],
            "parent_id": client["span_id"],
            "in_flight": False,
            "synthetic": True,
            "host": client.get("host", ""),
            "pid": client.get("pid", 0),
            "role": client.get("role", ""),
        }
        return [
            {**common, "name": SYNTH_HOP,
             "span_id": f"syn-{server['span_id']}-send",
             "ts_unix": c0, "dur_s": send,
             "attrs": {"direction": "send",
                       "from_role": client.get("role", ""),
                       "to_role": server.get("role", ""),
                       "over": server["span_id"]}},
            {**common, "name": SYNTH_HOP,
             "span_id": f"syn-{server['span_id']}-recv",
             "ts_unix": s0 + server["dur_s"], "dur_s": recv,
             "attrs": {"direction": "recv",
                       "from_role": server.get("role", ""),
                       "to_role": client.get("role", ""),
                       "over": server["span_id"]}},
        ]

    # -- exact decomposition ----------------------------------------------

    def decompose(self, trace_id: str, root_name: str = "router.request",
                  docs: list[dict] | None = None) -> dict:
        """Flatten one stitched trace into the exact parts of the root
        span's observed latency: local child spans, synthesized local
        idle gaps, and — for every child that crossed a process — the
        hop-send gap, the remote span, and the hop-recv gap in place of
        the client span's own duration.

        Returns ``{"e2e_s", "parts": [{name, dur_s, kind}, ...],
        "residual_s"}`` where ``residual_s == e2e_s - sum(parts)`` is
        zero up to float rounding — the acceptance invariant."""
        merged = self.stitch(docs)
        trace = merged["traces"].get(trace_id, [])
        real = [s for s in trace if not s["synthetic"]]
        roots = [s for s in real if s["name"] == root_name]
        if not roots:
            raise ValueError(f"no {root_name!r} span in trace {trace_id}")
        root = roots[0]
        children = sorted(
            (s for s in real
             if s.get("parent_id") == root["span_id"]
             and _src_key(s) == _src_key(root)),
            key=lambda s: s["ts_unix"])
        remote_by_parent: dict[str, dict] = {}
        for s in real:
            parent = s.get("parent_id", "")
            if parent and _src_key(s) != _src_key(root):
                remote_by_parent.setdefault(parent, s)
        # all arithmetic is rebased to the root's start (epoch-anchored
        # endpoints cancel at ~0.5µs float ulp; differences of small
        # numbers telescope exactly), and closing residuals are computed
        # from durations, not endpoint subtraction — exactness by
        # construction
        parts: list[dict] = []
        root_t0 = root["ts_unix"]
        cursor = 0.0  # elapsed-from-root already accounted for
        for child in children:
            rel = child["ts_unix"] - root_t0
            parts.append({"name": SYNTH_GAP, "dur_s": rel - cursor,
                          "kind": "gap"})
            remote = remote_by_parent.get(child["span_id"])
            if remote is not None:
                send = remote["ts_unix"] - child["ts_unix"]
                recv = child["dur_s"] - remote["dur_s"] - send
                parts.append({"name": SYNTH_HOP, "dur_s": send,
                              "kind": "hop",
                              "to_role": remote.get("role", "")})
                parts.append({"name": remote["name"],
                              "dur_s": remote["dur_s"], "kind": "remote",
                              "role": remote.get("role", "")})
                parts.append({"name": SYNTH_HOP, "dur_s": recv,
                              "kind": "hop",
                              "to_role": root.get("role", "")})
            else:
                parts.append({"name": child["name"],
                              "dur_s": child["dur_s"], "kind": "child"})
            cursor = rel + child["dur_s"]
        parts.append({"name": SYNTH_GAP, "dur_s": root["dur_s"] - cursor,
                      "kind": "gap"})
        e2e = root["dur_s"]
        residual = e2e - sum(p["dur_s"] for p in parts)
        return {"e2e_s": e2e, "parts": parts, "residual_s": residual,
                "trace_id": trace_id}

    # -- export ------------------------------------------------------------

    def chrome_trace(self, docs: list[dict] | None = None) -> dict:
        """One merged Chrome trace: every role's spans on its own
        process row (metadata-named ``role@host``), synthesized hops
        included so the timeline shows the wire time between rows."""
        merged = self.stitch(docs)
        spans = merged["spans"]
        if not spans:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {"sources": 0}}
        anchor = min(s["ts_unix"] for s in spans)
        events: list[dict] = []
        named: set = set()
        for s in spans:
            pid = s.get("pid", 0)
            if pid not in named:
                named.add(pid)
                events.append({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": (f"{s.get('role', '?')}"
                                      f"@{s.get('host', '?')}")},
                })
            events.append({
                "name": s["name"],
                "ph": "X",
                "ts": round((s["ts_unix"] - anchor) * 1e6, 3),
                "dur": round(max(0.0, s["dur_s"]) * 1e6, 3),
                "pid": pid,
                "tid": 0 if s["synthetic"] else 1,
                "cat": "m2kt.synthetic" if s["synthetic"] else "m2kt",
                "args": {**s.get("attrs", {}), "trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s.get("parent_id", ""),
                         "role": s.get("role", "")},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"anchor_unix": anchor,
                              "sources": len(named)}}

    def otlp_lines(self, docs: list[dict] | None = None) -> list[str]:
        """OTLP/JSON lines over the merged view — synthetic hop spans
        ride along flagged ``m2kt.synthetic`` so a real collector can
        drop or keep them."""
        merged = self.stitch(docs)
        lines = []
        for s in merged["spans"]:
            start_ns = int(s["ts_unix"] * 1e9)
            attrs = [{"key": "m2kt.role",
                      "value": {"stringValue": s.get("role", "")}},
                     {"key": "m2kt.synthetic",
                      "value": {"boolValue": bool(s["synthetic"])}}]
            for k, v in (s.get("attrs") or {}).items():
                attrs.append({"key": str(k),
                              "value": {"stringValue": str(v)}})
            span_id = s["span_id"]
            if s["synthetic"]:
                # synthetic ids are not 16-hex; derive a stable one
                span_id = format(abs(hash(span_id)) % (1 << 64), "016x")
            lines.append(json.dumps({"resourceSpans": [{
                "resource": {"attributes": [
                    {"key": "host.name",
                     "value": {"stringValue": s.get("host", "")}},
                    {"key": "service.name",
                     "value": {"stringValue": "move2kube-tpu"}},
                ]},
                "scopeSpans": [{
                    "scope": {"name": "m2kt.obs.fleetview"},
                    "spans": [{
                        "traceId": s["trace_id"],
                        "spanId": span_id,
                        "parentSpanId": s.get("parent_id", ""),
                        "name": s["name"],
                        "kind": 1,
                        "startTimeUnixNano": str(start_ns),
                        "endTimeUnixNano": str(
                            start_ns + int(max(0.0, s["dur_s"]) * 1e9)),
                        "attributes": attrs,
                    }],
                }],
            }]}, separators=(",", ":")))
        return lines
