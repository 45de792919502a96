"""Preemption watcher: turn SIGTERM into a coordinated last-chance save.
The port's own copy of ``move2kube_tpu/resilience/preemption.py``, with
the same knobs.

When a node is reclaimed (spot preemption, maintenance, scale-down) every
pod on it gets SIGTERM and ``terminationGracePeriodSeconds`` to die
cleanly. The emitted JobSet sizes that grace period to the checkpoint
budget and adds a preStop hook that touches a sentinel file; this watcher
notices either and tells the training loop to take one final synchronous
checkpoint and exit.

Multi-process rule: a checkpoint is only restorable if every process
saved the same step, but SIGTERM lands on one process first.
``should_stop`` therefore all-reduces the local flag (an int32 with
``MAX``) over the default ``torch.distributed`` process group on a fixed
step cadence (``sync_every``), so all processes agree on the stop step
before any of them saves. A world of one (or no process group) skips the
collective entirely.

Env knobs:

- ``M2KT_PREEMPT``            ``0`` disables the watcher (default on)
- ``M2KT_PREEMPT_GRACE_S``    grace budget in seconds (default 120)
- ``M2KT_PREEMPT_FILE``       preStop sentinel path
  (default ``/tmp/m2kt-preempt``)
- ``M2KT_PREEMPT_SYNC_EVERY`` agreement cadence in steps (default 10;
  unused in a world of one)
"""

from __future__ import annotations

import logging
import os
import signal
import time

log = logging.getLogger("m2kt.preemption")

DEFAULT_SENTINEL = "/tmp/m2kt-preempt"
DEFAULT_GRACE_S = 120.0
# emitted grace = checkpoint budget + margin for exit/teardown; the
# deployment layer derives terminationGracePeriodSeconds from the same
# numbers so the YAML and the watcher can't drift apart
DEFAULT_CKPT_BUDGET_S = 240
GRACE_MARGIN_S = 60


def grace_period_seconds() -> int:
    """The pod termination grace both the JobSet YAML and the emitted
    env agree on: checkpoint budget + teardown margin, env-overridable."""
    explicit = os.environ.get("M2KT_GRACE_PERIOD_S", "")
    if explicit:
        try:
            return max(1, int(explicit))
        except ValueError:
            log.warning("bad M2KT_GRACE_PERIOD_S=%r; using default", explicit)
    try:
        budget = int(os.environ.get("M2KT_CKPT_BUDGET_S",
                                    str(DEFAULT_CKPT_BUDGET_S)))
    except ValueError:
        budget = DEFAULT_CKPT_BUDGET_S
    return max(1, budget) + GRACE_MARGIN_S


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class PreemptionWatcher:
    """SIGTERM/sentinel watcher with multi-process stop-step agreement."""

    def __init__(self, grace_seconds: float = DEFAULT_GRACE_S,
                 sentinel: str = DEFAULT_SENTINEL, sync_every: int = 10):
        self.grace_seconds = grace_seconds
        self.sentinel = sentinel
        self.sync_every = max(1, sync_every)
        self._flagged_at: float | None = None
        self._prev_handler = None
        self._installed = False

    # -- local signal plumbing ---------------------------------------------

    def _on_sigterm(self, signum, frame) -> None:
        self._note_flagged("SIGTERM")
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)

    def _note_flagged(self, source: str) -> None:
        if self._flagged_at is None:
            self._flagged_at = time.monotonic()
            log.warning("preemption notice via %s; grace budget %.0fs",
                        source, self.grace_seconds)

    def install(self) -> "PreemptionWatcher":
        """Register the SIGTERM handler (chains to any previous one).
        Main-thread only, like all signal handling in Python."""
        if not self._installed:
            self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev_handler or signal.SIG_DFL)
            self._installed = False

    # -- queries ------------------------------------------------------------

    def requested(self) -> bool:
        """Process-local: has this process been told to stop?"""
        if self._flagged_at is None and self.sentinel and \
                os.path.exists(self.sentinel):
            self._note_flagged(f"sentinel {self.sentinel}")
        return self._flagged_at is not None

    def time_left(self) -> float | None:
        """Seconds of grace remaining (None until flagged)."""
        if self._flagged_at is None:
            return None
        return self.grace_seconds - (time.monotonic() - self._flagged_at)

    def should_stop(self, step: int) -> bool:
        """Call once per training step. True means: all processes have
        agreed this is the stop step; save synchronously now and exit.

        In a world above one this is a collective on the ``sync_every``
        cadence and MUST be called by every process at every step (the
        non-cadence steps are free)."""
        if _world_size() <= 1:
            return self.requested()
        if step % self.sync_every:
            return False
        import torch
        import torch.distributed as dist

        # the flag rides the process group's own device: a CPU tensor for
        # gloo, the current card for nccl
        dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        flag = torch.tensor([1 if self.requested() else 0],
                            dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        if agreed and self._flagged_at is None:
            # another process got the signal; adopt its deadline locally
            self._note_flagged("peer process")
        return agreed


def from_env() -> PreemptionWatcher | None:
    """Build the watcher the emitted trainers install at startup; None
    when disabled via M2KT_PREEMPT=0."""
    if os.environ.get("M2KT_PREEMPT", "1") == "0":
        return None
    try:
        grace = float(os.environ.get("M2KT_PREEMPT_GRACE_S",
                                     str(DEFAULT_GRACE_S)))
    except ValueError:
        grace = DEFAULT_GRACE_S
    try:
        sync_every = int(os.environ.get("M2KT_PREEMPT_SYNC_EVERY", "10"))
    except ValueError:
        sync_every = 10
    return PreemptionWatcher(
        grace_seconds=grace,
        sentinel=os.environ.get("M2KT_PREEMPT_FILE", DEFAULT_SENTINEL),
        sync_every=sync_every,
    )
