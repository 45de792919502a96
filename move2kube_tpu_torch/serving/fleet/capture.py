"""Fleet usage aggregation: chargeback and capture→replay.

The port's own copy of ``move2kube_tpu/serving/fleet/capture.py``, on
the port's obs modules, with the same names, keys and metric families.

This is the consumer side of the pod-local usage ledger
(``obs/ledger.py``). The aggregator scrapes ``GET /usage`` on every
fleet role (or reads the ``m2kt-usage.jsonl`` flight-recorder flushes
of pods that died between scrapes) and turns the snapshot rings into
the two artifacts the ledger exists for:

**Chargeback** (:func:`chargeback`): per-tenant card-seconds and a
$-proxy cost per token. Allocation is deliberately simple and stated:
each pod's wall time is split across tenants by their share of that
pod's *net* tokens (admitted minus unused corrections on routers,
prompt+decode histogram mass on engines); a pod with zero attributable
tokens bills to ``unattributed`` — so the raw TPU-seconds column sums
to exactly ``pods × wall`` and the bench gate can check the identity to
1%. A second, attainment-weighted column discounts each tenant's
seconds by its measured SLO attainment (capacity burned while missing
the SLO is the *operator's* cost, not the tenant's) — that column is
what ``m2kt_tenant_tpu_seconds_total`` exports. Dollar figures join the
``obs/costmodel`` chip table with public on-demand list prices; they
are a *proxy* for relative cost, not a bill.

**Capture** (:func:`build_capture`): the same snapshot deltas re-binned
into a versioned trace schema (``m2kt-capture/v1``): per-tenant
arrival/token counts per time bin plus prompt/output length and
latency histogram snapshots. :class:`CapturedTrace` replays a capture
as a drop-in for the simulator's synthetic diurnal
:class:`~move2kube_tpu_torch.serving.fleet.sim.Trace` — arrivals placed in
their recorded bins, lengths drawn from the recorded per-tenant
histograms, service times from the recorded latency shape — which
closes the loop the simulator left open: policies are judged on the
traffic the fleet actually saw, and :func:`fidelity` proves the replay
reproduces the measured aggregate rate and per-tenant token shares
before anyone trusts a verdict from it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import urllib.request
from dataclasses import dataclass

from move2kube_tpu_torch.obs.costmodel import chip_spec
from move2kube_tpu_torch.obs.ledger import hist_from_doc
from move2kube_tpu_torch.obs.metrics import Registry, default_registry

log = logging.getLogger("m2kt.fleet.capture")

CAPTURE_SCHEMA = "m2kt-capture/v1"
UNATTRIBUTED = "unattributed"

# $/chip-hour list prices keyed on ChipSpec.name, a relative-cost proxy,
# not a bill. The port carries none for its card: its dollar columns are
# 0 until a price is added here
DOLLARS_PER_CHIP_HOUR: dict = {}


def scrape_usage(url: str, timeout_s: float = 5.0) -> dict | None:
    """Fetch one pod's ``/usage`` document. Fail-open: any failure
    (refused, timeout, bad JSON) warns and returns None — a missing pod
    must degrade the report, never crash the aggregator."""
    try:
        if not url.rstrip("/").endswith("/usage"):
            url = url.rstrip("/") + "/usage"
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            doc = json.loads(resp.read().decode("utf-8"))
        return doc if isinstance(doc, dict) else None
    except Exception as e:  # noqa: BLE001 - aggregator is best-effort
        log.warning("usage scrape of %s failed: %s", url, e)
        return None


# ---------------------------------------------------------------------------
# snapshot arithmetic
# ---------------------------------------------------------------------------


def _hist_count(field) -> float:
    if isinstance(field, dict):
        return float(field.get("count", 0))
    return 0.0


def _hist_sum(field) -> float:
    if isinstance(field, dict):
        return float(field.get("sum", 0.0))
    return 0.0


def _tenant_tokens(fields: dict) -> float | None:
    """Cumulative net-token reading for one tenant in one snapshot, by
    source priority: router net admission (admitted − unused
    corrections), else engine request-shape histogram mass
    (prompt + generated tokens of completed requests)."""
    if "admitted_tokens" in fields:
        return max(0.0, float(fields.get("admitted_tokens", 0.0))
                   - float(fields.get("unused_tokens", 0.0)))
    if "prompt_tokens" in fields or "decode_tokens" in fields:
        return (_hist_sum(fields.get("prompt_tokens"))
                + _hist_sum(fields.get("decode_tokens")))
    return None


def pod_summary(doc: dict) -> dict:
    """Reduce one pod's snapshot ring to what chargeback and capture
    need: wall span, cumulative per-tenant tokens/requests at first and
    last snapshot, last-seen attainment, last-seen histograms."""
    snaps = [s for s in doc.get("snapshots", []) if isinstance(s, dict)]
    out = {
        "host": doc.get("host", "?"),
        "role": doc.get("role", "?"),
        "pid": doc.get("pid", 0),
        "wall_s": 0.0,
        "snapshots": len(snaps),
        "tenants": {},
    }
    if not snaps:
        return out
    first, last = snaps[0], snaps[-1]
    out["wall_s"] = max(0.0, float(last.get("t_mono", 0.0))
                        - float(first.get("t_mono", 0.0)))
    names = set(first.get("tenants", {})) | set(last.get("tenants", {}))
    for name in names:
        f0 = first.get("tenants", {}).get(name, {})
        f1 = last.get("tenants", {}).get(name, {})
        tok0, tok1 = _tenant_tokens(f0), _tenant_tokens(f1)
        requests = max(0.0, _hist_count(f1.get("decode_tokens"))
                       - _hist_count(f0.get("decode_tokens"))) or \
            max(0.0, float(f1.get("requests", 0.0))
                - float(f0.get("requests", 0.0)))
        out["tenants"][name] = {
            "tokens": max(0.0, (tok1 or 0.0) - (tok0 or 0.0)),
            "requests": requests,
            "attainment": float(f1.get("attainment", 1.0)),
            "hists": {k: f1[k] for k in ("prompt_tokens", "decode_tokens",
                                         "ttft", "token_latency")
                      if isinstance(f1.get(k), dict)},
        }
    return out


# ---------------------------------------------------------------------------
# chargeback
# ---------------------------------------------------------------------------


def chargeback(docs: list[dict], accelerator: str = "",
               chips_per_replica: int = 1) -> dict:
    """Join scraped usage docs with the chip cost table into the
    per-tenant chargeback report.

    The ``tpu_seconds`` keys keep the capture and chargeback schema the
    JAX package shares; on the port their values are card-seconds.

    Invariant the bench gates: the raw ``tpu_seconds`` column sums to
    exactly Σ pod walls (each pod's wall is fully allocated — tenants
    by token share, the remainder to ``unattributed``)."""
    spec, assumed = chip_spec(accelerator)
    price = DOLLARS_PER_CHIP_HOUR.get(spec.name, 0.0)
    pods = [pod_summary(d) for d in docs if isinstance(d, dict)]
    tenants: dict[str, dict] = {}

    def row(name: str) -> dict:
        return tenants.setdefault(name, {
            "tokens": 0.0, "requests": 0.0, "tpu_seconds": 0.0,
            "tpu_seconds_weighted": 0.0, "_att_wsum": 0.0})

    total_wall = 0.0
    for pod in pods:
        wall = pod["wall_s"]
        total_wall += wall
        toks = {n: t["tokens"] for n, t in pod["tenants"].items()}
        total = sum(toks.values())
        if total <= 0:
            row(UNATTRIBUTED)["tpu_seconds"] += wall
            row(UNATTRIBUTED)["tpu_seconds_weighted"] += wall
            continue
        for name, t in pod["tenants"].items():
            share = t["tokens"] / total
            r = row(name)
            seconds = share * wall
            r["tokens"] += t["tokens"]
            r["requests"] += t["requests"]
            r["tpu_seconds"] += seconds
            r["tpu_seconds_weighted"] += seconds * t["attainment"]
            r["_att_wsum"] += t["attainment"] * t["tokens"]
    for name, r in tenants.items():
        r["attainment"] = (r.pop("_att_wsum") / r["tokens"]
                           if r["tokens"] > 0 else 1.0)
        r["dollars"] = (r["tpu_seconds"] / 3600.0) * price \
            * max(1, int(chips_per_replica))
        r["dollars_per_mtok"] = (r["dollars"] / (r["tokens"] / 1e6)
                                 if r["tokens"] > 0 else 0.0)
    return {
        "schema": "m2kt-chargeback/v1",
        "generated_unix": time.time(),
        "accelerator": spec.name,
        "accelerator_assumed": assumed,
        "dollars_per_chip_hour": price,
        "chips_per_replica": max(1, int(chips_per_replica)),
        "pods": [{k: p[k] for k in ("host", "role", "pid", "wall_s",
                                    "snapshots")} for p in pods],
        "total_wall_s": total_wall,
        "total_tpu_seconds": sum(r["tpu_seconds"]
                                 for r in tenants.values()),
        "tenants": tenants,
    }


def export_tenant_seconds(report: dict,
                          registry: Registry | None = None) -> None:
    """Publish the attainment-weighted per-tenant TPU-seconds as
    ``m2kt_tenant_tpu_seconds_total`` (counter: each aggregation round
    adds the interval it just accounted)."""
    reg = registry if registry is not None else default_registry()
    fam = reg.counter(
        "m2kt_tenant_tpu_seconds_total",
        "Attainment-weighted TPU-seconds attributed to each tenant by "
        "the usage aggregator", labels=("tenant",))
    for name, r in report.get("tenants", {}).items():
        fam.labels(tenant=name).inc(max(0.0, r["tpu_seconds_weighted"]))


def render_report_markdown(report: dict) -> str:
    lines = [
        "# m2kt usage / chargeback report",
        "",
        f"- accelerator: **{report['accelerator']}**"
        + (" (assumed)" if report.get("accelerator_assumed") else "")
        + f" at ${report['dollars_per_chip_hour']:.2f}/chip-hour"
        + f" × {report['chips_per_replica']} chip(s)/replica",
        f"- pods: {len(report.get('pods', []))}, total wall "
        f"{report['total_wall_s']:.1f}s, allocated TPU-seconds "
        f"{report['total_tpu_seconds']:.1f}",
        "",
        "| tenant | tokens | requests | TPU-seconds | attainment-"
        "weighted | attainment | $ | $/Mtok |",
        "|---|---|---|---|---|---|---|---|",
    ]
    tenants = report.get("tenants", {})
    for name in sorted(tenants,
                       key=lambda n: -tenants[n]["tpu_seconds"]):
        r = tenants[name]
        lines.append(
            f"| {name} | {r['tokens']:.0f} | {r['requests']:.0f} "
            f"| {r['tpu_seconds']:.2f} | {r['tpu_seconds_weighted']:.2f} "
            f"| {r['attainment']:.3f} | {r['dollars']:.4f} "
            f"| {r['dollars_per_mtok']:.3f} |")
    return "\n".join(lines) + "\n"


def write_report(report: dict, out_dir: str) -> dict:
    """Write ``m2kt-usage-report.{json,md}`` (atomic, best-effort)."""
    paths = {}
    os.makedirs(out_dir, exist_ok=True)
    for ext, body in (("json", json.dumps(report, indent=1,
                                          sort_keys=True) + "\n"),
                      ("md", render_report_markdown(report))):
        path = os.path.join(out_dir, f"m2kt-usage-report.{ext}")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(body)
        os.replace(tmp, path)
        paths[ext] = path
    return paths


# ---------------------------------------------------------------------------
# capture: snapshot rings -> versioned trace
# ---------------------------------------------------------------------------


def _merge_hist(into: dict | None, doc: dict | None) -> dict | None:
    """Sum two hist docs bucket-wise (same edges — same code version);
    on an edge mismatch keep the heavier one rather than corrupt."""
    if doc is None:
        return into
    if into is None:
        return dict(doc)
    if list(into.get("buckets", ())) != list(doc.get("buckets", ())):
        return into if _hist_count(into) >= _hist_count(doc) else dict(doc)
    return {
        "buckets": list(into["buckets"]),
        "counts": [a + b for a, b in zip(into["counts"], doc["counts"])],
        "sum": into["sum"] + doc["sum"],
        "count": into["count"] + doc["count"],
    }


def build_capture(docs: list[dict], bin_s: float = 60.0) -> dict:
    """Re-bin the fleet's snapshot rings into the replayable capture.

    Per tenant: arrivals and net tokens per ``bin_s`` wall-clock bin
    (consecutive-snapshot deltas, credited to the later snapshot's
    bin), plus the last-seen prompt/output length histograms merged
    across pods. Fleet-level: merged TTFT and per-token latency
    histograms, so the replay draws service times from the measured
    latency shape."""
    bin_s = float(bin_s)
    stamps = [float(s["t_unix"])
              for d in docs if isinstance(d, dict)
              for s in d.get("snapshots", []) if "t_unix" in s]
    if not stamps:
        return {"schema": CAPTURE_SCHEMA, "bin_s": bin_s,
                "duration_s": 0.0, "captured_unix": time.time(),
                "tenants": {}, "latency": {}}
    t0 = min(stamps)
    n_bins = max(1, int(math.ceil((max(stamps) - t0) / bin_s)) or 1)
    tenants: dict[str, dict] = {}
    latency: dict[str, dict | None] = {"ttft": None, "token_latency": None}

    def trow(name: str) -> dict:
        return tenants.setdefault(name, {
            "arrivals_per_bin": [0.0] * n_bins,
            "tokens_per_bin": [0.0] * n_bins,
            "prompt_tokens": None, "decode_tokens": None})

    for doc in docs:
        if not isinstance(doc, dict):
            continue
        snaps = [s for s in doc.get("snapshots", [])
                 if isinstance(s, dict) and "t_unix" in s]
        for prev, cur in zip(snaps, snaps[1:]):
            b = min(n_bins - 1,
                    max(0, int((float(cur["t_unix"]) - t0) / bin_s)))
            pt, ct = prev.get("tenants", {}), cur.get("tenants", {})
            for name in set(pt) | set(ct):
                f0, f1 = pt.get(name, {}), ct.get(name, {})
                tok0, tok1 = _tenant_tokens(f0), _tenant_tokens(f1)
                if tok1 is not None:
                    trow(name)["tokens_per_bin"][b] += max(
                        0.0, tok1 - (tok0 or 0.0))
                arr = max(0.0, _hist_count(f1.get("decode_tokens"))
                          - _hist_count(f0.get("decode_tokens"))) or \
                    max(0.0, float(f1.get("requests", 0.0))
                        - float(f0.get("requests", 0.0)))
                trow(name)["arrivals_per_bin"][b] += arr
        if snaps:
            for name, fields in snaps[-1].get("tenants", {}).items():
                for key in ("prompt_tokens", "decode_tokens"):
                    if isinstance(fields.get(key), dict):
                        trow(name)[key] = _merge_hist(
                            tenants[name][key], fields[key])
                for key in ("ttft", "token_latency"):
                    if isinstance(fields.get(key), dict):
                        latency[key] = _merge_hist(
                            latency[key], fields[key])
    # drop tenants with no recorded traffic at all
    tenants = {n: t for n, t in tenants.items()
               if sum(t["tokens_per_bin"]) > 0
               or sum(t["arrivals_per_bin"]) > 0}
    return {
        "schema": CAPTURE_SCHEMA,
        "captured_unix": time.time(),
        "t0_unix": t0,
        "bin_s": bin_s,
        "duration_s": n_bins * bin_s,
        "tenants": tenants,
        "latency": {k: v for k, v in latency.items() if v is not None},
    }


# ---------------------------------------------------------------------------
# replay: capture -> simulator trace
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CapturedTraceConfig:
    """The slice of TraceConfig the event loop reads, sourced from a
    capture instead of synthetic knobs."""

    duration_s: float
    tick_s: float
    tenants: int
    seed: int = 0
    requests_total: int = 0


class CapturedTrace:
    """A production capture replayed as a simulator trace (duck-types
    :class:`~move2kube_tpu_torch.serving.fleet.sim.Trace`).

    Arrivals land uniformly inside their recorded wall-clock bin with
    their recorded per-tenant counts — the empirical rate curve, not a
    fitted sinusoid. Request shapes are drawn per tenant from the
    recorded length histograms; service times from the recorded latency
    shape (TTFT histogram as the prefill proxy — it includes queue
    wait, a stated conservative bias) unless an explicit ``latency``
    model is passed. One seed fixes every sample.
    """

    def __init__(self, capture: dict, latency=None, seed: int = 0,
                 rate_scale: float = 1.0) -> None:
        import numpy as np

        from move2kube_tpu_torch.serving.fleet import sim

        if capture.get("schema") != CAPTURE_SCHEMA:
            raise ValueError(
                f"unsupported capture schema {capture.get('schema')!r} "
                f"(want {CAPTURE_SCHEMA})")
        bin_s = float(capture["bin_s"])
        duration = float(capture["duration_s"])
        n_bins = max(1, int(round(duration / bin_s)))
        # tenant index order: heaviest first, matching the simulator's
        # zipf convention so tenant-0 is always the big one
        items = sorted(capture.get("tenants", {}).items(),
                       key=lambda kv: -sum(kv[1]["tokens_per_bin"]))
        self.tenant_names = [name for name, _ in items]
        rng = np.random.default_rng(seed)
        arrival, tenant_ix, prompt, decode = [], [], [], []
        agg_tokens_per_bin = np.zeros(n_bins)
        for ti, (name, rec) in enumerate(items):
            arrs = np.asarray(rec["arrivals_per_bin"], dtype=np.float64)
            toks = np.asarray(rec["tokens_per_bin"], dtype=np.float64)
            arrs = arrs[:n_bins]
            agg_tokens_per_bin[:len(toks[:n_bins])] += toks[:n_bins]
            p_snap = (hist_from_doc(rec["prompt_tokens"])
                      if rec.get("prompt_tokens") else None)
            d_snap = (hist_from_doc(rec["decode_tokens"])
                      if rec.get("decode_tokens") else None)
            p_sample = sim._snapshot_sampler(p_snap) if p_snap else None
            d_sample = sim._snapshot_sampler(d_snap) if d_snap else None
            # mean lengths as fallback when a tenant recorded tokens
            # but no shape histogram (router-only fleets)
            total_arr = arrs.sum()
            mean_tok = (toks.sum() / total_arr) if total_arr > 0 else 0.0
            t_prompt, t_decode = [], []
            for b in range(len(arrs)):
                k = int(round(arrs[b] * rate_scale))
                if k <= 0:
                    continue
                arrival.append(b * bin_s + rng.random(k) * bin_s)
                tenant_ix.append(np.full(k, ti, dtype=np.int64))
                if p_sample is not None:
                    t_prompt.append(np.maximum(1.0, p_sample(k, rng)))
                else:
                    t_prompt.append(np.full(k, max(1.0, mean_tok / 2.0)))
                if d_sample is not None:
                    t_decode.append(np.maximum(1.0, d_sample(k, rng)))
                else:
                    t_decode.append(np.full(k, max(1.0, mean_tok / 2.0)))
            if not t_prompt:
                continue
            tp = np.concatenate(t_prompt)
            td = np.concatenate(t_decode)
            # the histograms supply the length SHAPE; the counter deltas
            # supply the token MASS. Rescale so this tenant's replayed
            # total matches its recorded total exactly — inverse-CDF
            # sampling alone drifts the mean by the in-bucket
            # interpolation error, which the 10% rate gate would eat.
            recorded = toks.sum() * rate_scale
            sampled = tp.sum() + td.sum()
            if recorded > 0 and sampled > 0:
                scale = recorded / sampled
                tp *= scale
                td *= scale
            prompt.append(tp)
            decode.append(td)
        if not arrival:
            raise ValueError("capture contains no replayable arrivals")
        arrival = np.concatenate(arrival)
        order = np.argsort(arrival, kind="stable")
        self.arrival_s = arrival[order]
        self.tenant = np.concatenate(tenant_ix)[order]
        prompt = np.concatenate(prompt)[order]
        decode = np.concatenate(decode)[order]
        self.tokens = (prompt + decode).astype(np.float64)
        self.n = int(self.arrival_s.size)
        self.distinct_users = self.n  # capture carries no user ids
        if latency is None:
            lat = capture.get("latency", {})
            if lat.get("ttft") and lat.get("token_latency"):
                latency = sim.LatencyModel.from_histograms(
                    hist_from_doc(lat["ttft"]),
                    hist_from_doc(lat["token_latency"]))
            else:
                latency = sim.LatencyModel.synthetic()
        prefill_s, per_token_s = latency.sample(self.n, rng)
        self.prefill_s = prefill_s
        self.service_s = prefill_s + decode * per_token_s
        self.cfg = CapturedTraceConfig(
            duration_s=duration, tick_s=bin_s,
            tenants=len(self.tenant_names), seed=seed,
            requests_total=self.n)
        bins = np.minimum((self.arrival_s / bin_s).astype(np.int64),
                          n_bins - 1)
        self.tokens_per_tick = np.bincount(
            bins, weights=self.tokens, minlength=n_bins)
        self.mean_slot_tps = float(
            self.tokens.mean() / max(1e-9, self.service_s.mean()))
        self._shape_t = (np.arange(n_bins) + 0.5) * bin_s
        shape = agg_tokens_per_bin / max(1e-9, agg_tokens_per_bin.mean())
        self._shape = np.maximum(0.05, shape)

    def rate_shape(self, t):
        """Empirical relative rate: the recorded per-bin token curve,
        interpolated (and periodically extended — the predictive
        policy's warm-up asks about yesterday)."""
        import numpy as np

        t = np.asarray(t, dtype=np.float64) % max(
            1e-9, self.cfg.duration_s)
        return np.interp(t, self._shape_t, self._shape)


def fidelity(capture: dict, trace) -> dict:
    """Replay-fidelity check the bench gates: relative error of the
    aggregate token rate plus the max absolute per-tenant token-share
    error between the capture and a (replayed) trace."""
    rec_tokens = {name: float(sum(rec["tokens_per_bin"]))
                  for name, rec in capture.get("tenants", {}).items()}
    rec_total = sum(rec_tokens.values())
    duration = max(1e-9, float(capture.get("duration_s", 0.0)))
    rep_total = float(trace.tokens.sum())
    rate_err = abs(rep_total - rec_total) / max(1e-9, rec_total)
    names = getattr(trace, "tenant_names",
                    [f"tenant-{i}" for i in range(trace.cfg.tenants)])
    rep_tokens = {}
    for ti, name in enumerate(names):
        mask = trace.tenant == ti
        rep_tokens[name] = float(trace.tokens[mask].sum())
    share_err = {}
    for name in set(rec_tokens) | set(rep_tokens):
        rec_share = rec_tokens.get(name, 0.0) / max(1e-9, rec_total)
        rep_share = rep_tokens.get(name, 0.0) / max(1e-9, rep_total)
        share_err[name] = abs(rec_share - rep_share)
    return {
        "recorded_tokens": rec_total,
        "replayed_tokens": rep_total,
        "recorded_tps": rec_total / duration,
        "replayed_tps": rep_total / duration,
        "rate_err": rate_err,
        "share_err": share_err,
        "max_share_err": max(share_err.values()) if share_err else 0.0,
    }


# ---------------------------------------------------------------------------
# aggregator: the scrape loop the autoscaler role runs
# ---------------------------------------------------------------------------

USAGE_SCRAPE_URLS_ENV = "M2KT_USAGE_SCRAPE_URLS"
USAGE_SCRAPE_INTERVAL_ENV = "M2KT_USAGE_SCRAPE_INTERVAL_S"
USAGE_OUT_DIR_ENV = "M2KT_USAGE_OUT_DIR"
DEFAULT_SCRAPE_INTERVAL_S = 60.0


def write_capture(capture: dict, out_dir: str) -> str:
    """Write ``m2kt-capture.json`` (atomic)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "m2kt-capture.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(capture, f, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_capture(path: str) -> dict:
    """Read a capture doc back; raises ValueError on a schema mismatch
    (an old aggregator's file must not silently replay wrong)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != CAPTURE_SCHEMA:
        raise ValueError(
            f"capture schema {doc.get('schema')!r} != {CAPTURE_SCHEMA!r}")
    return doc


class UsageAggregator:
    """Scrape every fleet role's ``/usage``, keep the last good doc per
    pod (a restarting pod degrades to its previous ring, never to a
    hole), and refresh the chargeback report + replay capture on disk
    each cycle. Runs inside the autoscaler role — the one fleet pod
    that already holds the scrape-and-decide loop."""

    def __init__(self, urls, out_dir: str | None = None,
                 accelerator: str = "", chips_per_replica: int = 1,
                 bin_s: float = 60.0, interval_s: float | None = None,
                 registry: Registry | None = None,
                 clock=time.monotonic) -> None:
        self.urls = [u for u in urls if u]
        self.out_dir = out_dir or os.environ.get(
            USAGE_OUT_DIR_ENV,
            os.environ.get("M2KT_METRICS_DIR", "/tmp/m2kt-metrics"))
        self.accelerator = accelerator
        self.chips_per_replica = max(1, int(chips_per_replica))
        self.bin_s = float(bin_s)
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    USAGE_SCRAPE_INTERVAL_ENV, DEFAULT_SCRAPE_INTERVAL_S))
            except ValueError:
                interval_s = DEFAULT_SCRAPE_INTERVAL_S
        self.interval_s = max(1.0, float(interval_s))
        self._registry = (registry if registry is not None
                          else default_registry())
        self._clock = clock
        self._last: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread = None
        self._scrapes = self._registry.counter(
            "m2kt_usage_scrapes_total",
            "Usage-aggregator scrape attempts", labels=("outcome",))
        self.report: dict | None = None
        self.capture: dict | None = None

    @classmethod
    def from_env(cls, registry: Registry | None = None):
        """Build from ``M2KT_USAGE_SCRAPE_URLS`` (comma-separated pod
        base URLs); None when unset — the aggregator is opt-in per
        deployment because it needs the pod list."""
        spec = os.environ.get(USAGE_SCRAPE_URLS_ENV, "").strip()
        if not spec:
            return None
        return cls([u.strip() for u in spec.split(",") if u.strip()],
                   registry=registry)

    def poll(self) -> dict | None:
        """One scrape+publish cycle; returns the refreshed report."""
        for url in self.urls:
            doc = scrape_usage(url)
            if doc is not None:
                self._last[url] = doc
                self._scrapes.labels("ok").inc()
            else:
                self._scrapes.labels("error").inc()
        docs = list(self._last.values())
        if not docs:
            return None
        self.report = chargeback(docs, accelerator=self.accelerator,
                                 chips_per_replica=self.chips_per_replica)
        export_tenant_seconds(self.report, self._registry)
        self.capture = build_capture(docs, bin_s=self.bin_s)
        try:
            write_report(self.report, self.out_dir)
            write_capture(self.capture, self.out_dir)
        except OSError as e:
            log.warning("usage artifact write failed: %s", e)
        return self.report

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="m2kt-usage-agg")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 - loop must survive
                log.warning("usage aggregation cycle failed: %s", e)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
