"""Runtime telemetry plane of the port: its own copy of
``move2kube_tpu/obs/``, under the same names.

- a Prometheus registry (:mod:`.metrics`) and the stdlib HTTP server that
  exposes it with ``/healthz``, ``/readyz``, ``/traces``, ``/usage`` and
  on-demand ``torch.profiler`` captures at ``/profile`` (:mod:`.server`);
- request and step tracing with the flight-recorder ring dump
  (:mod:`.tracing`), and the cross-role trace collector
  (:mod:`.fleetview`);
- the per-tenant SLO ledger (:mod:`.slo`) and the usage ledger
  (:mod:`.ledger`);
- the goodput and trace mirrors, the straggler detector and the anomaly
  watchdog (:mod:`.bridge`);
- the step cost model with the memory sidecar (:mod:`.costmodel`) and the
  tensor-health plane (:mod:`.numerics`).

Not ported, with the ROADMAP item that brings each: ``build_plan_report``
and ``write_plan_report`` come with ``parallel/memory.py`` (Queue 1 item
9); ``analyze_compiled`` reads an XLA executable and has no counterpart
(:func:`analyze_step_fn` and :func:`.costmodel.count_cost` count an eager
run instead).
"""

from move2kube_tpu_torch.obs.bridge import (
    DiagWatchdog,
    StragglerDetector,
    diag_dir,
    diag_enabled,
    install_goodput_hook,
    install_trace_hook,
    mirror_goodput,
    mirror_trace,
)
from move2kube_tpu_torch.obs.costmodel import (
    CHIP_SPECS,
    ChipSpec,
    CostReport,
    analyze_step_fn,
    chip_spec,
    export_drift_gauge,
    export_serving_gauges,
    export_train_gauges,
    install_memory_snapshot,
    normalize_accelerator,
    write_memory_snapshot,
)
from move2kube_tpu_torch.obs.fleetview import FleetTraceCollector
from move2kube_tpu_torch.obs.ledger import (
    UsageLedger,
    engine_source,
    install_usage_flush,
    router_source,
    usage_path,
)
from move2kube_tpu_torch.obs.ledger import enabled as usage_enabled
from move2kube_tpu_torch.obs.metrics import (
    OVERFLOW_LABEL,
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
)
from move2kube_tpu_torch.obs.numerics import (
    HEALTH_FIELDS,
    TensorHealthState,
    first_bad_group,
    group_index,
    health_from_state,
    health_recorder,
    read_sidecar,
    sidecar_path,
    summarize_tree,
    write_sidecar,
)
from move2kube_tpu_torch.obs.numerics import audit_rate as quant_audit_rate
from move2kube_tpu_torch.obs.numerics import enabled as numerics_enabled
from move2kube_tpu_torch.obs.numerics import summary as numerics_summary
from move2kube_tpu_torch.obs.server import (
    DEFAULT_METRICS_PORT,
    METRICS_PORT_ENV,
    PROFILE_DIR_ENV,
    TelemetryServer,
    metrics_port_from_env,
    start_telemetry_server,
)
from move2kube_tpu_torch.obs.slo import (
    TENANT_HEADER,
    SLOSpec,
    SLOTracker,
    clean_tenant,
    max_tenants,
)
from move2kube_tpu_torch.obs.tracing import (
    TRACEPARENT_HEADER,
    Span,
    SpanRecorder,
    fleet_role,
    install_ring_flush,
    parse_traceparent,
)
from move2kube_tpu_torch.obs.tracing import enabled as tracing_enabled
from move2kube_tpu_torch.obs.tracing import get as get_tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "TelemetryServer",
    "start_telemetry_server",
    "metrics_port_from_env",
    "DEFAULT_METRICS_PORT",
    "METRICS_PORT_ENV",
    "PROFILE_DIR_ENV",
    "mirror_trace",
    "mirror_goodput",
    "install_trace_hook",
    "install_goodput_hook",
    "StragglerDetector",
    "DiagWatchdog",
    "diag_dir",
    "diag_enabled",
    "UsageLedger",
    "engine_source",
    "router_source",
    "install_usage_flush",
    "usage_enabled",
    "usage_path",
    "Span",
    "SpanRecorder",
    "get_tracer",
    "tracing_enabled",
    "install_ring_flush",
    "parse_traceparent",
    "fleet_role",
    "TRACEPARENT_HEADER",
    "FleetTraceCollector",
    "SLOSpec",
    "SLOTracker",
    "TENANT_HEADER",
    "clean_tenant",
    "max_tenants",
    "OVERFLOW_LABEL",
    "CHIP_SPECS",
    "ChipSpec",
    "CostReport",
    "analyze_step_fn",
    "chip_spec",
    "export_drift_gauge",
    "export_serving_gauges",
    "export_train_gauges",
    "install_memory_snapshot",
    "normalize_accelerator",
    "write_memory_snapshot",
    "HEALTH_FIELDS",
    "TensorHealthState",
    "first_bad_group",
    "group_index",
    "health_from_state",
    "health_recorder",
    "numerics_enabled",
    "numerics_summary",
    "quant_audit_rate",
    "read_sidecar",
    "sidecar_path",
    "summarize_tree",
    "write_sidecar",
]
