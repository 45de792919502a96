"""Deterministic fault injection for resume-path testing: the port's own
copy of ``move2kube_tpu/resilience/faults.py``, under the same knobs.

The resume story ("a process that dies at step N restarts from N") is
only real if a test can prove it. This module gives the training loop one
cheap hook, :func:`maybe_inject`, driven entirely by ``M2KT_FAULT_*``
env vars, plus helpers that damage the newest on-disk checkpoint the way
a preempted host does (partial writes, truncation).

Knobs (all inert when unset; production runs never set them):

- ``M2KT_FAULT_STEP``      step number at which the fault fires
- ``M2KT_FAULT_KIND``      ``exit`` (sys.exit, default) | ``raise``
  (RuntimeError, reads as a retryable crash) | ``sigkill`` (os.kill
  SIGKILL: the no-cleanup death a host failure produces) |
  ``slice_loss`` (exits with :data:`SLICE_LOST_EXIT_CODE` after naming
  the lost slice on stderr, which the supervisor classifies as
  ``slice_lost``)
- ``M2KT_FAULT_EXIT_CODE`` exit code for ``exit`` (default 1)
- ``M2KT_FAULT_SLICE``     which slice ``slice_loss`` reclaims (default 1)
- ``M2KT_FAULT_MARKER``    path to an exactly-once marker: the fault
  fires only when the file is absent and creates it first, so the
  supervisor's restarted attempt survives. Without a marker the fault
  fires on every attempt (for testing retry exhaustion).

The serving fleet's injectors (:mod:`..serving.fleet.chaos`) use the same
exactly-once marker; :func:`serving_chaos` arms them.

The checkpoint helpers work on the port's layout
(:mod:`..models.checkpoint`): one ``<dir>/<step>/`` directory per
committed save, holding ``state.pt`` and ``meta.json``.

Stdlib only.
"""

from __future__ import annotations

import logging
import os
import signal
import sys

log = logging.getLogger("m2kt.faults")

# Exit code for a slice-loss death. The emitted JobSet's podFailurePolicy
# keys a restart-without-burning-maxRestarts rule on it, and the
# supervisor classifies it as ``slice_lost``.
SLICE_LOST_EXIT_CODE = 83

# the committed step directory's files (models/checkpoint.py)
PAYLOAD_FILE = "state.pt"
META_FILE = "meta.json"


class FaultInjected(RuntimeError):
    """Raised by the ``raise`` fault kind (classified retryable)."""


def _marker_fired(marker: str) -> bool:
    """True when the exactly-once marker says this fault already fired;
    otherwise claims it (O_EXCL so concurrent processes race safely)."""
    if not marker:
        return False
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return True
    os.close(fd)
    return False


def maybe_inject(step: int) -> None:
    """Fire the configured fault when ``step`` matches; no-op otherwise.

    Called once per training step: two env reads when unconfigured,
    nothing cached so tests can flip the knobs between runs.
    """
    raw = os.environ.get("M2KT_FAULT_STEP", "")
    if not raw:
        return
    try:
        at = int(raw)
    except ValueError:
        return
    if step != at:
        return
    if _marker_fired(os.environ.get("M2KT_FAULT_MARKER", "")):
        return
    kind = os.environ.get("M2KT_FAULT_KIND", "exit")
    log.warning("injecting fault kind=%s at step %d", kind, step)
    print(f"[m2kt] FAULT: injected {kind} at step {step}", flush=True)
    if kind == "raise":
        raise FaultInjected(f"injected transient fault at step {step}")
    if kind == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    if kind == "slice_loss":
        # stderr, not stdout: the supervisor classifies on the stderr tail
        lost = os.environ.get("M2KT_FAULT_SLICE", "1")
        print(f"[m2kt] FAULT: slice_loss: slice {lost} reclaimed at step "
              f"{step}; DCN peers unreachable", file=sys.stderr, flush=True)
        sys.exit(SLICE_LOST_EXIT_CODE)
    sys.exit(int(os.environ.get("M2KT_FAULT_EXIT_CODE", "1")))


def serving_chaos():
    """The serving-side injector, armed from ``M2KT_CHAOS_*`` env vars
    (None when nothing is configured). Imported on call: this module
    stays stdlib-only."""
    from move2kube_tpu_torch.serving.fleet.chaos import maybe_chaos

    return maybe_chaos()


# -- checkpoint damage (what a preempted host leaves behind) ----------------


def step_dirs(ckpt_dir: str) -> list[tuple[int, str]]:
    """(step, path) for every committed step directory, ascending. A save
    in flight (or killed mid-write) lives under a temporary name that is
    not all digits, so it is never listed."""
    out = []
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return []
    for name in entries:
        p = os.path.join(ckpt_dir, name)
        if os.path.isdir(p) and name.isdigit():
            out.append((int(name), p))
    return sorted(out)


def _payload_files(step_dir: str) -> list[str]:
    """The step's payload (``state.pt``); when it is missing (layout
    change), the metadata is the victim."""
    payload = os.path.join(step_dir, PAYLOAD_FILE)
    if os.path.isfile(payload):
        return [payload]
    meta = os.path.join(step_dir, META_FILE)
    return [meta] if os.path.isfile(meta) else []


def corrupt_latest(ckpt_dir: str, mode: str = "truncate") -> int:
    """Damage the newest committed checkpoint; returns the step damaged.

    ``truncate`` halves each payload file (partial write); ``scribble``
    overwrites their heads with garbage (bit rot / torn block);
    ``remove`` deletes them (lost objects). Raises FileNotFoundError
    when there is no checkpoint to damage.
    """
    steps = step_dirs(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {ckpt_dir!r}")
    step, sdir = steps[-1]
    victims = _payload_files(sdir)
    if not victims:
        raise FileNotFoundError(f"checkpoint step dir {sdir!r} is empty")
    for victim in victims:
        if mode == "remove":
            os.remove(victim)
        elif mode == "scribble":
            size = os.path.getsize(victim)
            with open(victim, "r+b") as f:
                f.write(b"\xde\xad\xbe\xef" * max(1, min(size, 4096) // 4))
        else:  # truncate
            size = os.path.getsize(victim)
            with open(victim, "r+b") as f:
                f.truncate(size // 2)
    log.warning("corrupted checkpoint step %d (%s x%d: %s ...)",
                step, mode, len(victims), victims[0])
    return step
