"""Goodput/badput accounting for training runs: the port's own copy of
``move2kube_tpu/resilience/goodput.py``, with the same report format and
file name.

Goodput is the fraction of wall-clock spent making forward progress. A
job that restarts every hour with a 10-minute recovery tail has 83%
goodput no matter how fast its steps are. Every trainer owns a
:class:`GoodputTracker`; the supervisor merges per-attempt reports into a
pod-level summary with the lost span (time between the last flushed
checkpoint and the death).

Categories:

- ``productive`` time spent in training steps that were checkpointed
  (or ran to completion);
- ``compile``    the first step (kernel builds and loads, allocator
  warm-up; badput that recurs on every restart without a build cache);
- ``restore``    checkpoint restore at startup;
- ``save``       synchronous checkpoint waits;
- ``retry``      supervisor backoff sleeps between attempts;
- ``replan``     the supervisor's pause before an elastic relaunch;
- ``lost``       work after the last checkpoint flush that a failure
  threw away (recomputed on resume).

:func:`mirror_to_obs` folds a report into the port's metrics registry,
:func:`mirror_to_trace` into the port's span recorder.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

CATEGORIES = ("productive", "compile", "restore", "save", "retry", "replan",
              "lost")

DEFAULT_FILENAME = "m2kt-goodput.json"


def report_path() -> str:
    """Where this process flushes its goodput report (M2KT_GOODPUT_FILE,
    else M2KT_METRICS_DIR, else the working directory)."""
    explicit = os.environ.get("M2KT_GOODPUT_FILE", "")
    if explicit:
        return explicit
    out_dir = os.environ.get("M2KT_METRICS_DIR", "") or "."
    return os.path.join(out_dir, DEFAULT_FILENAME)


class GoodputTracker:
    """Accumulate per-category seconds + step progress for one attempt.

    The tracker is flushed to disk on every checkpoint save (one small
    JSON dump), so after an abrupt death the supervisor still sees the
    state as of the last checkpoint and can attribute everything after it
    to ``lost``.
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.steps_done = 0
        self.last_saved_step = 0
        self.resumed_from = 0
        self.started = time.time()

    def add(self, category: str, seconds: float, steps: int = 0) -> None:
        self.seconds[category] = self.seconds.get(category, 0.0) + seconds
        if steps:
            self.steps_done += steps

    @contextmanager
    def phase(self, category: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(category, time.perf_counter() - t0)

    def note_resume(self, step: int) -> None:
        self.resumed_from = step
        self.steps_done = step

    def note_saved(self, step: int) -> None:
        self.last_saved_step = max(self.last_saved_step, step)

    def report(self) -> dict:
        wall = time.time() - self.started
        accounted = sum(self.seconds.values())
        productive = self.seconds["productive"]
        denom = max(wall, accounted, 1e-9)
        return {
            "wall_seconds": round(wall, 3),
            "seconds": {k: round(v, 3) for k, v in self.seconds.items()},
            "goodput_fraction": round(productive / denom, 4),
            "steps_done": self.steps_done,
            "last_saved_step": self.last_saved_step,
            "resumed_from": self.resumed_from,
        }

    def write(self, path: str | None = None) -> str:
        path = path or report_path()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)  # atomic: a kill mid-dump can't corrupt it
        return path


def read_report(path: str) -> dict | None:
    """Best-effort read of a flushed report (None when absent/corrupt)."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def merge_attempts(attempts: list[dict]) -> dict:
    """Pod-level summary across supervisor attempts.

    Each entry: ``{"report": <flushed report or None>, "wall_seconds":
    <attempt wall as measured by the supervisor>, "ok": bool}``. For a
    failed attempt the span between its last flush and its death is
    unrecorded by definition: the supervisor measured the attempt's true
    wall clock, so everything the flushed report does not account for is
    ``lost`` (work thrown away + the death tail).
    """
    totals = {c: 0.0 for c in CATEGORIES}
    steps = last_saved = 0
    for att in attempts:
        rep = att.get("report") or {}
        secs = rep.get("seconds", {})
        for c in CATEGORIES:
            totals[c] += float(secs.get(c, 0.0))
        steps = max(steps, int(rep.get("steps_done", 0)))
        last_saved = max(last_saved, int(rep.get("last_saved_step", 0)))
        if not att.get("ok"):
            accounted = sum(float(secs.get(c, 0.0)) for c in CATEGORIES)
            lost = max(0.0, float(att.get("wall_seconds", 0.0)) - accounted)
            totals["lost"] += lost
    wall = sum(float(a.get("wall_seconds", 0.0)) for a in attempts)
    denom = max(wall, sum(totals.values()), 1e-9)
    return {
        "attempts": len(attempts),
        "wall_seconds": round(wall, 3),
        "seconds": {k: round(v, 3) for k, v in totals.items()},
        "goodput_fraction": round(totals["productive"] / denom, 4),
        "steps_done": steps,
        "last_saved_step": last_saved,
    }


def mirror_to_obs(report: dict, registry=None) -> None:
    """Fold a report into the port's metrics registry (gauges: fraction,
    per-category seconds, step watermarks), so a ``/metrics`` scrape
    carries goodput next to the step telemetry."""
    from move2kube_tpu_torch.obs.bridge import mirror_goodput

    mirror_goodput(report, registry)


def trace_counters(report: dict, prefix: str = "goodput") -> dict:
    """The reference's trace counters of a report: ``<prefix>.<category>_ms``
    (milliseconds), ``<prefix>.steps_done`` and ``<prefix>.fraction_bp``
    (basis points)."""
    out = {f"{prefix}.{cat}_ms": int(secs * 1000)
           for cat, secs in report.get("seconds", {}).items()}
    out[f"{prefix}.steps_done"] = int(report.get("steps_done", 0))
    frac = report.get("goodput_fraction")
    if frac is not None:
        out[f"{prefix}.fraction_bp"] = int(float(frac) * 10000)
    return out


def mirror_to_trace(report: dict, prefix: str = "goodput",
                    recorder=None) -> None:
    """Fold a report into the port's span recorder: one zero-length span
    named ``prefix`` whose attributes are :func:`trace_counters`, so the
    ring the flight recorder folds carries the ledger. ``recorder``
    defaults to the process-wide one; a no-op while tracing is off."""
    from move2kube_tpu_torch.obs import tracing

    if recorder is None:
        if not tracing.enabled():
            return
        recorder = tracing.get()
    now = time.perf_counter()
    recorder.record(prefix, now, now, attrs=trace_counters(report, prefix))
