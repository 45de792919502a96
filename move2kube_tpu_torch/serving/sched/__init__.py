"""Multi-tenant scheduler plane of the port (own copies of
``move2kube_tpu/serving/sched``).

Consumed from both ends of the serving stack: the router front runs
admission control (per-tenant token buckets and priority classes) and
the engine consults the same policies for preemption ordering and serves
paged multi-LoRA adapters, all behind one spec string so the two sides
cannot disagree.
"""

from move2kube_tpu_torch.serving.sched.admission import (  # noqa: F401
    DEFAULT_PRIORITY,
    PRIORITIES,
    AdmissionController,
    SchedThrottled,
    TenantPolicy,
    TokenBucket,
    merge_split_specs,
    parse_tenant_spec,
)
from move2kube_tpu_torch.serving.sched.lora import (  # noqa: F401
    NULL_ADAPTER,
    AdapterStore,
)

__all__ = [
    "AdmissionController",
    "AdapterStore",
    "DEFAULT_PRIORITY",
    "NULL_ADAPTER",
    "PRIORITIES",
    "SchedThrottled",
    "TenantPolicy",
    "TokenBucket",
    "merge_split_specs",
    "parse_tenant_spec",
]
