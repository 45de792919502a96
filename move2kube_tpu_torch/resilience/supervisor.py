"""In-pod supervisor: retry the trainer, classify its deaths, keep score.
The port's own copy of ``move2kube_tpu/resilience/supervisor.py``, with
the same classes, knobs (``M2KT_RETRY_*``, ``M2KT_ELASTIC*``,
``M2KT_EXIT_FILE``), files and exit codes: the emitted JobSets and their
failure policies key on them.

A full JobSet restart re-schedules pods and rebuilds every kernel on a
cold node: minutes of badput. Cheap transient failures (a flaky
connection, an injected test fault, a spurious crash) are better retried
*inside* the pod, where the kernel build cache and the mounted
checkpoint are warm. This wrapper is the trainer image's entrypoint::

    python -m move2kube_tpu_torch.resilience.supervisor -- python train.py

Behavior:

- runs the trainer as a child, streaming its stderr through while
  keeping a tail for exit classification;
- classifies each death as ``ok`` / ``preempted`` / ``slice_lost`` /
  ``retryable`` / ``fatal`` (table below) and restarts retryable ones
  with exponential backoff, up to ``M2KT_RETRY_MAX`` attempts;
- **elastic mode** (``M2KT_ELASTIC=1``): a ``slice_lost`` death re-plans
  for the survivors by shrinking ``M2KT_NUM_SLICES`` in the child's env,
  rescaling ``M2KT_BATCH_PER_DEVICE`` (and ``M2KT_FORCE_DEVICES``) to keep
  the global batch when divisible, and restarts without burning the retry
  budget, down to ``M2KT_ELASTIC_MIN_SLICES`` (default 1). The pause is
  charged to the goodput ledger's ``replan`` category. The port's
  trainers run one slice until Queue 1 item 9; the env arithmetic is the
  reference's;
- forwards SIGTERM to the child and stops retrying (a preempted pod is
  going away; the last-chance checkpoint already happened in the child),
  and puts its own SIGTERM handler back on every way out;
- merges the per-attempt goodput reports (:mod:`.goodput`) into a
  pod-level summary, mirrored into the port's span recorder and, with
  ``M2KT_METRICS_DIR``, into ``m2kt-metrics.json`` there;
- on a retryable, fatal or slice-lost death, folds the child's span ring
  and its ``.mem`` and ``.numerics`` sidecars (written beside
  :func:`~move2kube_tpu_torch.obs.tracing.flight_path`) with the goodput
  ledger and the stderr tail into ``m2kt-flight.json``;
- writes a structured exit-reason file (``M2KT_EXIT_FILE``, default
  ``m2kt-exit.json``).

Classification table (first match wins):

====================  ==========  =======================================
signal / pattern      class       rationale
====================  ==========  =======================================
rc 0                  ok          trainer finished
SIGTERM / rc 143      preempted   node reclaim; don't fight the eviction
rc 83 / "slice        slice_lost  a whole slice reclaimed; elastic
lost", "slice_loss"               mode re-plans on the survivors
SIGKILL / rc 137      retryable   OOM-killer or host kill; warm restart
SyntaxError,          fatal       the image is broken; a retry loop
ImportError,                      cannot fix code
ModuleNotFoundError
"exceeds the",        fatal       config rejected at startup (positional
"not divisible"                   table, mesh shape); deterministic
DEADLINE_EXCEEDED,    retryable   transient runtime/collective trouble
UNAVAILABLE,
connection/barrier/
heartbeat, libtpu,
RESOURCE_EXHAUSTED
anything else         retryable   optimistic but bounded by the retry
                                  budget; exhaustion reports the last rc
====================  ==========  =======================================
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque

from move2kube_tpu_torch.resilience import goodput
from move2kube_tpu_torch.resilience.faults import SLICE_LOST_EXIT_CODE

log = logging.getLogger("m2kt.supervisor")

OK = "ok"
PREEMPTED = "preempted"
SLICE_LOST = "slice_lost"
RETRYABLE = "retryable"
FATAL = "fatal"

# slice-loss signatures: the injected fault's stderr line and what a
# surviving slice's processes print when the megascale DCN transport
# loses its peers; checked before the generic fatal/retryable tables
SLICE_LOST_PATTERNS = (
    "FAULT: slice_loss", "slice lost", "SliceUnreachable",
    "megascale slice unreachable",
)

# substring tables over the stderr tail; fatal checked first
FATAL_PATTERNS = (
    "SyntaxError", "ImportError", "ModuleNotFoundError",
    "exceeds the", "not divisible",
)
RETRYABLE_PATTERNS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "RESOURCE_EXHAUSTED",
    "onnection", "Broken pipe", "barrier", "heartbeat",
    "libtpu", "TPU initialization", "FaultInjected", "injected transient",
)

STDERR_TAIL_CHARS = 4000
BACKOFF_CAP_S = 60.0


def classify(returncode: int, stderr_tail: str = "") -> str:
    """Map a child exit to ok / preempted / slice_lost / retryable /
    fatal."""
    if returncode == 0:
        return OK
    if returncode in (-signal.SIGTERM, 128 + signal.SIGTERM):
        return PREEMPTED
    if returncode == SLICE_LOST_EXIT_CODE:
        return SLICE_LOST
    for pat in SLICE_LOST_PATTERNS:
        if pat in stderr_tail:
            return SLICE_LOST
    if returncode in (-signal.SIGKILL, 128 + signal.SIGKILL):
        return RETRYABLE
    for pat in FATAL_PATTERNS:
        if pat in stderr_tail:
            return FATAL
    for pat in RETRYABLE_PATTERNS:
        if pat in stderr_tail:
            return RETRYABLE
    return RETRYABLE


def exit_file_path() -> str:
    explicit = os.environ.get("M2KT_EXIT_FILE", "")
    if explicit:
        return explicit
    out_dir = os.environ.get("M2KT_METRICS_DIR", "") or "."
    return os.path.join(out_dir, "m2kt-exit.json")


class Supervisor:
    def __init__(self, cmd: list[str], max_retries: int | None = None,
                 backoff_s: float | None = None,
                 exit_file: str | None = None):
        if max_retries is None:
            max_retries = int(os.environ.get("M2KT_RETRY_MAX", "3"))
        if backoff_s is None:
            backoff_s = float(os.environ.get("M2KT_RETRY_BACKOFF_S", "5"))
        self.cmd = list(cmd)
        self.max_retries = max(0, max_retries)
        self.backoff_s = max(0.0, backoff_s)
        self.exit_file = exit_file or exit_file_path()
        self.elastic = os.environ.get("M2KT_ELASTIC", "0") == "1"
        try:
            self.min_slices = max(1, int(
                os.environ.get("M2KT_ELASTIC_MIN_SLICES", "1") or 1))
        except ValueError:
            self.min_slices = 1
        self._child: subprocess.Popen | None = None
        self._got_sigterm = False
        self._attempts: list[dict] = []
        self._retry_sleep_total = 0.0
        self._replan_sleep_total = 0.0
        self._replan_events: list[dict] = []
        # env deltas for the NEXT attempt (elastic re-plan shrinks the
        # slice count here rather than mutating this process's environ)
        self._env_overrides: dict[str, str] = {}

    # -- signal forwarding --------------------------------------------------

    def _on_sigterm(self, signum, frame) -> None:
        self._got_sigterm = True
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signal.SIGTERM)
            except OSError:
                pass

    # -- one attempt --------------------------------------------------------

    def _run_once(self) -> tuple[int, str, float]:
        """Run the child once; returns (rc, stderr_tail, wall_seconds).
        Child stdout passes straight through; stderr is tee'd so the pod
        log is intact AND the tail is available for classification."""
        tail: deque[str] = deque(maxlen=200)
        t0 = time.monotonic()
        env = ({**os.environ, **self._env_overrides}
               if self._env_overrides else None)
        self._child = subprocess.Popen(
            self.cmd, stderr=subprocess.PIPE, text=True, errors="replace",
            env=env)

        def _tee(pipe):
            for line in pipe:
                sys.stderr.write(line)
                tail.append(line)
            pipe.close()

        t = threading.Thread(target=_tee, args=(self._child.stderr,),
                             daemon=True)
        t.start()
        rc = self._child.wait()
        t.join(timeout=10.0)
        self._child = None
        return rc, "".join(tail)[-STDERR_TAIL_CHARS:], time.monotonic() - t0

    # -- the loop -----------------------------------------------------------

    def run(self) -> int:
        prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        try:
            return self._run_supervised()
        finally:
            signal.signal(signal.SIGTERM, prev)

    def _run_supervised(self) -> int:
        gp_path = goodput.report_path()
        attempt = 0
        while True:
            attempt += 1
            # stale report from the previous attempt must not be re-read
            # if this attempt dies before its first flush
            try:
                os.remove(gp_path)
            except OSError:
                pass
            rc, tail, wall = self._run_once()
            clazz = classify(rc, tail)
            if self._got_sigterm:
                clazz = PREEMPTED
            report = goodput.read_report(gp_path)
            self._attempts.append({
                "attempt": attempt, "returncode": rc, "class": clazz,
                "wall_seconds": round(wall, 3),
                "stderr_tail": tail[-2000:],
                "report": report, "ok": clazz == OK,
            })
            log.warning("attempt %d exited rc=%d class=%s", attempt, rc, clazz)
            if clazz in (RETRYABLE, FATAL, SLICE_LOST):
                # flight recorder: capture THIS death's context now —
                # an elastic re-plan or a successful retry will end the
                # pod with class ok, but the flight from the dead
                # attempt is exactly what the postmortem needs
                self._write_flight(clazz, rc, attempt, report)
            if clazz == OK:
                return self._finish(OK, 0)
            if clazz == PREEMPTED:
                return self._finish(PREEMPTED, 128 + signal.SIGTERM)
            if clazz == SLICE_LOST:
                event = self._plan_elastic_restart(attempt) if self.elastic \
                    else None
                if event is None:
                    # not elastic (or survivors below the floor): report
                    # slice_lost so the JobSet failure policy — which
                    # restarts the set without burning maxRestarts on
                    # exit code 83 — makes the scale-level decision
                    return self._finish(SLICE_LOST, SLICE_LOST_EXIT_CODE)
                # small floor so the ledger's replan category is never
                # silently zero even under a zeroed test backoff
                delay = max(0.05, self.backoff_s)
                print(f"[m2kt] supervisor: attempt {attempt} slice_lost; "
                      f"elastic re-plan {event['from_slices']}->"
                      f"{event['to_slices']} slices, restarting in "
                      f"{delay:.1f}s", flush=True)
                time.sleep(delay)
                self._replan_sleep_total += delay
                continue
            if clazz == FATAL:
                return self._finish(FATAL, self._normalize_rc(rc))
            if attempt > self.max_retries:
                return self._finish("retries_exhausted",
                                    self._normalize_rc(rc))
            delay = min(BACKOFF_CAP_S, self.backoff_s * (2 ** (attempt - 1)))
            print(f"[m2kt] supervisor: attempt {attempt} {clazz} (rc={rc}); "
                  f"restarting in {delay:.1f}s "
                  f"({self.max_retries - attempt + 1} retries left)",
                  flush=True)
            time.sleep(delay)
            self._retry_sleep_total += delay

    @staticmethod
    def _normalize_rc(rc: int) -> int:
        return 128 - rc if rc < 0 else (rc or 1)

    # -- elastic re-plan ----------------------------------------------------

    def _plan_elastic_restart(self, attempt: int) -> dict | None:
        """Shrink the next attempt's world to the surviving slices.

        Returns the recorded re-plan event, or None when the survivors
        would fall below ``M2KT_ELASTIC_MIN_SLICES`` (terminal: hand the
        decision back to the JobSet failure policy). The child re-plans
        the mesh itself (``resolve_mesh_plan`` reads the shrunken
        ``M2KT_NUM_SLICES``) and restores the last checkpoint into it.

        Global batch: ``M2KT_BATCH_PER_DEVICE`` is scaled up by
        old/new-slice ratio when that stays integral, so the optimizer
        sees identical global batches across the loss; when indivisible
        the per-device batch is kept and the event records the degraded
        global batch instead of silently changing convergence math.
        ``M2KT_FORCE_DEVICES`` (the CPU harness's forced-host device
        count) shrinks proportionally so the drill models the lost
        hardware, not just the lost label."""
        env = {**os.environ, **self._env_overrides}
        try:
            num = max(1, int(env.get("M2KT_NUM_SLICES", "1") or 1))
        except ValueError:
            num = 1
        survivors = num - 1
        if survivors < self.min_slices:
            log.warning(
                "slice lost but %d survivor(s) under the elastic floor "
                "(M2KT_ELASTIC_MIN_SLICES=%d); not re-planning",
                survivors, self.min_slices)
            return None
        overrides = {"M2KT_NUM_SLICES": str(survivors)}
        event: dict = {"attempt": attempt, "from_slices": num,
                       "to_slices": survivors}
        force = env.get("M2KT_FORCE_DEVICES", "")
        if force.isdigit() and int(force) % num == 0:
            overrides["M2KT_FORCE_DEVICES"] = str(
                int(force) // num * survivors)
        bpd = env.get("M2KT_BATCH_PER_DEVICE", "")
        if bpd.isdigit() and (int(bpd) * num) % survivors == 0:
            overrides["M2KT_BATCH_PER_DEVICE"] = str(
                int(bpd) * num // survivors)
            event["batch_per_device"] = int(overrides["M2KT_BATCH_PER_DEVICE"])
            event["global_batch_preserved"] = True
        else:
            # indivisible (or per-device batch unknown to the pod env):
            # keep the per-device batch, record the degradation
            event["global_batch_preserved"] = False
        self._env_overrides.update(overrides)
        self._replan_events.append(event)
        return event

    def _write_flight(self, exit_class: str, rc: int, attempt: int,
                      report: dict | None) -> None:
        """Crash flight recorder: fold the dead child's span ring (the
        child flushes its last ``M2KT_TRACE_RING_SECONDS`` of spans to
        ``<flight>.ring`` on teardown — ``obs.tracing.install_ring_flush``)
        together with its goodput ledger and the stderr tail into
        ``m2kt-flight.json``. A SIGKILL'd child leaves no ring; the
        flight then carries the ledger and classification alone.
        Best-effort: a flight the supervisor cannot write must never
        change the exit path."""
        from move2kube_tpu_torch.obs import tracing

        ring: dict = {}
        ring_file = tracing.ring_path()
        try:
            with open(ring_file, encoding="utf-8") as f:
                ring = json.load(f)
        except (OSError, ValueError):
            pass
        # OOM forensics (obs/costmodel.py): the child's <flight>.mem
        # sidecar carries the CUDA allocator's statistics at its last
        # snapshot, what an out-of-memory or OOM-killed (137) postmortem
        # needs. Absent for children that never wrote one.
        memory: dict = {}
        try:
            with open(tracing.flight_path() + ".mem",
                      encoding="utf-8") as f:
                memory = json.load(f)
        except (OSError, ValueError):
            pass
        # numerics forensics (obs/numerics.py): the child's
        # <flight>.numerics sidecar names the first layer group that
        # went non-finite plus the per-group tensor health of that step
        # — written by StepTelemetry the moment a NaN/Inf was recorded,
        # so it survives even a child that died before the next sync.
        numerics_doc: dict = {}
        try:
            with open(tracing.flight_path() + ".numerics",
                      encoding="utf-8") as f:
                numerics_doc = json.load(f)
        except (OSError, ValueError):
            pass
        tail = self._attempts[-1].get("stderr_tail", "") \
            if self._attempts else ""
        flight = {
            "exit_class": exit_class,
            "returncode": rc,
            "attempt": attempt,
            "written_unix": time.time(),
            "cmd": self.cmd,
            "stderr_tail": tail[-2000:],
            "goodput": report or {},
            "ring": {k: ring.get(k) for k in
                     ("host", "slice_id", "pid", "written_unix",
                      "ring_seconds", "dropped")} if ring else {},
            "spans": ring.get("spans", []),
            "memory": memory,
            "numerics": numerics_doc,
        }
        path = tracing.flight_path()
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(flight, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
            log.warning("flight recorder: %s (%d spans) -> %s",
                        exit_class, len(flight["spans"]), path)
        except OSError as e:
            log.warning("could not write flight file %s: %s", path, e)

    def _finish(self, exit_class: str, code: int) -> int:
        merged = goodput.merge_attempts(self._attempts)
        merged["seconds"]["retry"] = round(
            merged["seconds"].get("retry", 0.0) + self._retry_sleep_total, 3)
        merged["seconds"]["replan"] = round(
            merged["seconds"].get("replan", 0.0) + self._replan_sleep_total, 3)
        summary = {
            "exit_class": exit_class,
            "returncode": code,
            "cmd": self.cmd,
            "attempts": [
                {k: v for k, v in a.items() if k != "ok"}
                for a in self._attempts
            ],
            "replan_events": self._replan_events,
            "goodput": merged,
        }
        try:
            d = os.path.dirname(os.path.abspath(self.exit_file))
            os.makedirs(d, exist_ok=True)
            tmp = self.exit_file + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(summary, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.exit_file)
        except OSError as e:
            log.warning("could not write exit-reason file %s: %s",
                        self.exit_file, e)
        goodput.mirror_to_trace(merged)
        metrics_dir = os.environ.get("M2KT_METRICS_DIR", "")
        if metrics_dir:
            try:
                _write_pod_metrics(metrics_dir, merged)
            except Exception as e:  # noqa: BLE001 - metrics are best-effort
                log.warning("could not write pod metrics: %s", e)
        print(f"[m2kt] supervisor: {exit_class} after "
              f"{len(self._attempts)} attempt(s); goodput="
              f"{merged['goodput_fraction']:.2%} "
              f"(lost {merged['seconds']['lost']:.1f}s, "
              f"retry {merged['seconds']['retry']:.1f}s)", flush=True)
        return code


def _write_pod_metrics(out_dir: str, merged: dict,
                       filename: str = "m2kt-metrics.json") -> str:
    """The pod metrics file, in the reference's format (``{"spans": {},
    "counters": {...}}``) with the merged goodput's trace counters."""
    path = os.path.join(out_dir, filename)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"spans": {}, "counters": goodput.trace_counters(merged)},
                  f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        opts, cmd = argv[:split], argv[split + 1:]
    else:
        opts, cmd = [], argv
    if not cmd:
        print("usage: python -m move2kube_tpu_torch.resilience.supervisor "
              "[--max-retries N] [--backoff-s S] -- <command...>",
              file=sys.stderr)
        return 2
    max_retries = backoff = None
    it = iter(opts)
    for tok in it:
        if tok == "--max-retries":
            max_retries = int(next(it, "3"))
        elif tok == "--backoff-s":
            backoff = float(next(it, "5"))
        else:
            print(f"unknown supervisor option {tok!r}", file=sys.stderr)
            return 2
    return Supervisor(cmd, max_retries=max_retries, backoff_s=backoff).run()


if __name__ == "__main__":
    sys.exit(main())
