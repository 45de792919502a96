"""Preemption-aware resilience for the port's training workloads: its own
copy of ``move2kube_tpu/resilience/``, under the same module names, knobs,
files and exit codes.

- ``preemption``  SIGTERM / preStop-sentinel watcher that coordinates a
  last-chance synchronous checkpoint inside the pod's termination grace
  period (the stop step agreed over ``torch.distributed``);
- ``supervisor``  in-pod retry wrapper around the trainer: classifies
  fatal vs. retryable exits, restarts with exponential backoff, writes a
  structured exit-reason file and the crash flight doc
  (``python -m move2kube_tpu_torch.resilience.supervisor -- ...``);
- ``faults``      deterministic fault injection (die at step N,
  corrupt/truncate the latest checkpoint) so resume paths are provable
  in tests;
- ``goodput``     goodput/badput accounting (productive step time vs.
  compile/restore/save/retry/lost), flushed to a JSON report and
  mirrored into the port's metrics registry and span recorder;
- ``minitrain``   a tiny real trainer wired through all of the above: the
  fault-injection harness target
  (``python -m move2kube_tpu_torch.resilience.minitrain``).

The entry-point modules (``supervisor``, ``minitrain``) are not imported
here, so ``python -m`` runs each of them once.
"""

from move2kube_tpu_torch.resilience.faults import (
    SLICE_LOST_EXIT_CODE,
    FaultInjected,
    corrupt_latest,
    maybe_inject,
    serving_chaos,
    step_dirs,
)
from move2kube_tpu_torch.resilience.goodput import (
    GoodputTracker,
    merge_attempts,
    mirror_to_obs,
    mirror_to_trace,
    read_report,
)
from move2kube_tpu_torch.resilience.preemption import (
    PreemptionWatcher,
    grace_period_seconds,
)

__all__ = [
    "FaultInjected",
    "GoodputTracker",
    "PreemptionWatcher",
    "SLICE_LOST_EXIT_CODE",
    "corrupt_latest",
    "grace_period_seconds",
    "maybe_inject",
    "merge_attempts",
    "mirror_to_obs",
    "mirror_to_trace",
    "read_report",
    "serving_chaos",
    "step_dirs",
]
