"""Step cost model: MFU/roofline accounting and memory forensics, the
port's own copy of ``move2kube_tpu/obs/costmodel.py``.

The reference reads a compiled XLA executable's ``cost_analysis`` and
``memory_analysis``. The port compiles nothing, so it counts one eager
run of the step instead (:func:`count_cost`):

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the
  dispatched ops, plus what the attention kernels add while a count is
  open. A kernel launched through ``ctypes`` dispatches no aten op, so
  each wrapper in :mod:`move2kube_tpu_torch.ops.attention` adds its plain
  version's FLOPs itself (:func:`~move2kube_tpu_torch.ops.attention.
  count_kernel_cost`): the card and the CPU, where the plain versions'
  einsums run, report the same total for the same step;
* **bytes accessed**: the operand and result bytes of every dispatched
  non-view op, plus each kernel's inputs read once and outputs written
  once. An unfused upper bound of the traffic, not XLA's post-fusion
  ``bytes accessed``;
* **peak bytes**: on the card, ``torch.cuda.max_memory_allocated`` around
  the run (``memory["args"]``: allocated when it starts; ``"temps"``: the
  peak above that). None on the CPU;
* **arithmetic intensity, roofline class and MFU** from those, against
  the card's row of :data:`CHIP_SPECS`.

Exported as the reference's gauges (``m2kt_train_mfu``,
``m2kt_hbm_peak_bytes{category}``, ``m2kt_roofline_bound``,
``m2kt_serve_*``), and kept for the crash flight recorder's
``<flight>.mem`` sidecar (:func:`install_memory_snapshot`), written from
``torch.cuda.memory_stats()`` under the reference's keys.

The preflight plan report (:func:`build_plan_report`,
:func:`write_plan_report`, the ``m2kt-plan-report/v1`` schema) sets the
memory plan of :mod:`move2kube_tpu_torch.parallel.memory` beside the
card's budget and, when a step has run, beside this module's cost report:
its ``compiled`` section is the counted step, and the drift is the
prediction over ``torch.cuda.max_memory_allocated`` of that step.

Not ported: the XLA introspection (``analyze_compiled``,
``lower_and_compile``), which has no counterpart. torch is imported only
inside the functions that need it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

from move2kube_tpu_torch.obs import tracing

ACCELERATOR_ENV = "M2KT_TPU_ACCELERATOR"
PLAN_REPORT_ENV = "M2KT_PLAN_REPORT"
PLAN_REPORT_STRICT_ENV = "M2KT_PLAN_REPORT_STRICT"

# predicted-vs-measured peak-memory tolerance, the reference's: the
# analytic plan and the measurement agree within 4x either way
PLAN_DRIFT_TOLERANCE_FACTOR = 4.0

# roofline classes, also the value of the m2kt_roofline_bound gauge
COMPUTE_BOUND = 1.0
BANDWIDTH_BOUND = 0.0
UNKNOWN_BOUND = -1.0


@dataclass(frozen=True)
class ChipSpec:
    """Per-card peak numbers (public data sheets)."""

    name: str
    peak_bf16_flops: float
    peak_int8_flops: float
    hbm_bytes: float
    hbm_bandwidth: float  # bytes/s

    @property
    def ridge_flops_per_byte(self) -> float:
        """Arithmetic intensity at which the roofline's bandwidth and
        compute ceilings meet; programs below it are bandwidth-bound."""
        return self.peak_bf16_flops / self.hbm_bandwidth


# keyed on GKE's ``cloud.google.com/gke-accelerator`` node-label strings.
# The port runs on the H100 SXM: dense bf16 and int8 tensor-core peaks,
# 80 GB of HBM3 at 3.35 TB/s (NVIDIA data sheet)
CHIP_SPECS = {
    "nvidia-h100-80gb": ChipSpec(
        "h100-sxm", peak_bf16_flops=989e12, peak_int8_flops=1979e12,
        hbm_bytes=80e9, hbm_bandwidth=3.35e12),
}

# the row that stands in, flagged as assumed, when nothing resolves
DEFAULT_CHIP = "nvidia-h100-80gb"

# alias -> canonical key; matched on the lowercased string with
# separators stripped, so torch's device name "NVIDIA H100 80GB HBM3"
# lands on the row
_ALIASES = {
    "h100": "nvidia-h100-80gb",
    "nvidiah100": "nvidia-h100-80gb",
    "h10080gb": "nvidia-h100-80gb",
    "nvidiah10080gb": "nvidia-h100-80gb",
    "h100sxm": "nvidia-h100-80gb",
}
# H100 variants with other peaks than the SXM row's
_OTHER_H100 = ("pcie", "nvl")


def normalize_accelerator(accelerator: str) -> str | None:
    """Canonical :data:`CHIP_SPECS` key for an accelerator string (a GKE
    accelerator label or a CUDA device name), or None when nothing
    matches."""
    raw = str(accelerator or "").strip().lower()
    if not raw:
        return None
    if raw in CHIP_SPECS:
        return raw
    squashed = "".join(c for c in raw if c.isalnum())
    if any(tag in squashed for tag in _OTHER_H100):
        return None
    # strip a trailing card count ("h1008")
    base = squashed.rstrip("0123456789")
    for key in (squashed, base):
        if key in _ALIASES:
            return _ALIASES[key]
    for key, canon in _ALIASES.items():
        if key in squashed and len(key) >= 3:
            return canon
    return None


def chip_spec(accelerator: str = "") -> tuple[ChipSpec, bool]:
    """(spec, assumed): the spec for ``accelerator`` (or, unset, the
    ``M2KT_TPU_ACCELERATOR`` env, else the name of the CUDA card when one
    is present). ``assumed`` is True when nothing resolved and the H100
    row stands in; numbers derived from it are still emitted, and the
    reports flag them."""
    raw = accelerator or os.environ.get(ACCELERATOR_ENV, "")
    if not raw:
        import torch

        if torch.cuda.is_available():
            raw = torch.cuda.get_device_name()
    canon = normalize_accelerator(raw)
    if canon is None:
        return CHIP_SPECS[DEFAULT_CHIP], True
    return CHIP_SPECS[canon], False


def peak_hbm_total(mem: dict) -> int | None:
    """Peak footprint: arguments + outputs + temps (aliased bytes counted
    once) plus program text, as the reference sums them; the port fills
    ``args`` and ``temps`` only. None when nothing was measured."""
    if not mem:
        return None
    total = (mem.get("args", 0) + mem.get("outputs", 0)
             + mem.get("temps", 0) + mem.get("generated_code", 0)
             - mem.get("aliased", 0))
    return max(0, int(total))


@dataclass
class CostReport:
    """Cost model of one step or pass on one card."""

    flops: float | None = None
    bytes_accessed: float | None = None
    memory: dict = field(default_factory=dict)
    raw_cost_keys: int = 0

    @property
    def arithmetic_intensity(self) -> float | None:
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    @property
    def peak_hbm_bytes(self) -> int | None:
        return peak_hbm_total(self.memory)

    def roofline(self, spec: ChipSpec) -> str:
        """"compute" / "bandwidth" / "unknown" against the card's ridge."""
        ai = self.arithmetic_intensity
        if ai is None:
            return "unknown"
        return ("compute" if ai >= spec.ridge_flops_per_byte
                else "bandwidth")

    def mfu(self, step_seconds: float | None, spec: ChipSpec,
            int8: bool = False) -> float | None:
        """Achieved model-FLOP utilization of one card for a measured step
        wall time; None when either half is unknown. ``int8`` divides by
        the int8 peak instead of bf16's."""
        if not self.flops or not step_seconds or step_seconds <= 0:
            return None
        peak = spec.peak_int8_flops if int8 else spec.peak_bf16_flops
        return (self.flops / step_seconds) / peak

    def mfu_ceiling(self, spec: ChipSpec) -> float | None:
        """Roofline MFU ceiling: intensity/ridge for a bandwidth-bound
        step, 1.0 when compute-bound."""
        ai = self.arithmetic_intensity
        if ai is None:
            return None
        return min(1.0, ai / spec.ridge_flops_per_byte)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "arithmetic_intensity": self.arithmetic_intensity,
            "memory": dict(self.memory),
            "peak_hbm_bytes": self.peak_hbm_bytes,
        }


# ---------------------------------------------------------------------------
# counting one run
# ---------------------------------------------------------------------------


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


def _bytes_mode():
    """A dispatch mode summing the operand and result bytes of every
    non-view op it sees (``.nbytes``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class BytesMode(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not getattr(func, "is_view", False):
                self.nbytes += sum(t.numel() * t.element_size()
                                   for t in _tensors((args, kwargs, out)))
            return out

    return BytesMode()


def _device_of(args):
    for a in args:
        model = getattr(a, "model", None)
        params = getattr(model, "parameters", None)
        if callable(params):
            p = next(params(), None)
            if p is not None:
                return p.device
        for t in _tensors(a):
            return t.device
    return None


def count_cost(fn, *args, device=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters; returns
    ``(its result, CostReport)``. The kernels' own counts join the
    FlopCounterMode total; every kernel launched in the process while the
    count is open is counted. ``device`` (by default the device of the
    first model or tensor in ``args``) is where peak bytes are read, on a
    CUDA device only."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from move2kube_tpu_torch.ops.attention import count_kernel_cost

    dev = device if device is not None else _device_of(args)
    cuda = dev is not None and torch.device(dev).type == "cuda"
    before = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    bytes_mode = _bytes_mode()
    with FlopCounterMode(display=False) as flops, \
            count_kernel_cost() as kernels, bytes_mode:
        out = fn(*args, **kwargs)
    memory = {}
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        memory = {"args": int(before), "temps": int(max(0, peak - before))}
    report = CostReport(
        flops=float(flops.get_total_flops() + kernels["flops"]),
        bytes_accessed=float(bytes_mode.nbytes + kernels["bytes"]),
        memory=memory, raw_cost_keys=2)
    return out, report


def analyze_step_fn(step_fn, *args) -> CostReport | None:
    """Count one run of the train step ``step_fn(*args)``
    (:func:`count_cost`) with every optimizer in ``args`` held
    (``Optimizer.held``: no update, no record) and each ``TrainState``'s
    step count and model buffers put back after, so the state comes out
    as it went in; the model's ``.grad`` holds this run's gradients until
    the next step's ``zero_grad``. The report's memory is also kept for
    the flight sidecar (:func:`note_memory_report`)."""
    with contextlib.ExitStack() as stack:
        restore = []
        for a in args:
            opt = getattr(a, "optimizer", a)
            held = getattr(opt, "held", None)
            if callable(held):
                stack.enter_context(held())
            model = getattr(a, "model", None)
            if model is not None and hasattr(a, "step"):
                buffers = {n: b.clone() for n, b in model.named_buffers()}
                restore.append((a, a.step, model, buffers))
        _, report = count_cost(step_fn, *args)
        for state, step, model, buffers in restore:
            state.step = step
            for name, buf in model.named_buffers():
                buf.copy_(buffers[name])
    note_memory_report(report)
    return report


# ---------------------------------------------------------------------------
# gauge export
# ---------------------------------------------------------------------------

_BOUND_VALUE = {"compute": COMPUTE_BOUND, "bandwidth": BANDWIDTH_BOUND,
                "unknown": UNKNOWN_BOUND}


def export_train_gauges(report: CostReport, registry=None, *,
                        accelerator: str = "",
                        step_seconds: float | None = None) -> float | None:
    """Set the training cost-model gauges from one report: MFU (0 when
    flops or timing are unknown, so the family is always present), the
    roofline class, per-category peak bytes, and the raw flops/intensity.
    Returns the MFU (None when it could not be derived). The help text is
    the reference's; the assumed spec here is the H100 row."""
    from move2kube_tpu_torch.obs.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    spec, assumed = chip_spec(accelerator)
    mfu = report.mfu(step_seconds, spec)
    reg.gauge(
        "m2kt_train_mfu",
        "Achieved model-FLOP utilization per chip (0 = unknown)",
    ).set(mfu or 0.0)
    reg.gauge(
        "m2kt_roofline_bound",
        "Roofline class of the train step (1 compute-bound, "
        "0 bandwidth-bound, -1 unknown)",
    ).set(_BOUND_VALUE[report.roofline(spec)])
    reg.gauge(
        "m2kt_train_step_flops",
        "Per-chip FLOPs of the compiled train step",
    ).set(report.flops or 0.0)
    reg.gauge(
        "m2kt_train_arithmetic_intensity",
        "Train-step FLOPs per HBM byte accessed",
    ).set(report.arithmetic_intensity or 0.0)
    reg.gauge(
        "m2kt_chip_spec_assumed",
        "1 when the accelerator string did not resolve and the v5e "
        "spec was assumed for MFU/roofline math",
    ).set(1.0 if assumed else 0.0)
    reg.gauge(
        "m2kt_chip_hbm_bytes",
        "HBM capacity of the chip generation the cost model resolved",
    ).set(spec.hbm_bytes)
    hbm = reg.gauge(
        "m2kt_hbm_peak_bytes",
        "Compiled-executable HBM footprint by category",
        labels=("category",))
    for category, nbytes in report.memory.items():
        hbm.labels(category=category).set(nbytes)
    total = report.peak_hbm_bytes
    if total is not None:
        hbm.labels(category="total").set(total)
    return mfu


def export_serving_gauges(reports: dict, registry=None, *,
                          accelerator: str = "",
                          decode_step_seconds: float | None = None,
                          quant: str = "off") -> None:
    """Per-pass serving gauges from ``{name: CostReport}`` (the engine's
    bucketed prefills and its decode/verify passes): roofline class and
    FLOPs by executable, peak bytes by (executable, category), and the
    decode MFU from the engine's measured decode time, against the int8
    peak when ``quant`` quantizes."""
    from move2kube_tpu_torch.obs.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    spec, _ = chip_spec(accelerator)
    int8 = quant != "off"
    bound = reg.gauge(
        "m2kt_serve_roofline_bound",
        "Roofline class per serving executable (1 compute, 0 bandwidth, "
        "-1 unknown)", labels=("executable",))
    flops = reg.gauge(
        "m2kt_serve_step_flops",
        "Per-chip FLOPs per serving executable", labels=("executable",))
    hbm = reg.gauge(
        "m2kt_serve_hbm_peak_bytes",
        "Serving executable HBM footprint by category",
        labels=("executable", "category"))
    for name, report in reports.items():
        bound.labels(executable=name).set(
            _BOUND_VALUE[report.roofline(spec)])
        flops.labels(executable=name).set(report.flops or 0.0)
        for category, nbytes in report.memory.items():
            hbm.labels(executable=name, category=category).set(nbytes)
        total = report.peak_hbm_bytes
        if total is not None:
            hbm.labels(executable=name, category="total").set(total)
    # with spec decoding on, verify IS the steady-state decode pass
    decode = reports.get("verify") or reports.get("decode")
    if decode is not None:
        reg.gauge(
            "m2kt_serve_mfu",
            "Achieved decode-step MFU per chip (0 = unknown)",
        ).set(decode.mfu(decode_step_seconds, spec, int8=int8) or 0.0)


def export_drift_gauge(predicted_total: float | None,
                       measured_total: float | None,
                       registry=None) -> float | None:
    """Predicted/measured peak-bytes ratio as a gauge (1.0 = the analytic
    model matched the measurement). Returns the ratio, or None (gauge set
    to 0) when either side is unknown."""
    from move2kube_tpu_torch.obs.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    ratio = None
    if predicted_total and measured_total:
        ratio = float(predicted_total) / float(measured_total)
    reg.gauge(
        "m2kt_plan_hbm_drift_ratio",
        "Predicted (MemoryPlan) over measured (memory_analysis) peak-HBM "
        "bytes; 0 = unknown",
    ).set(ratio or 0.0)
    return ratio


# ---------------------------------------------------------------------------
# preflight plan report
# ---------------------------------------------------------------------------


def plan_report_dir() -> str | None:
    """Where ``m2kt-plan-report.{json,md}`` lands: ``M2KT_PLAN_REPORT``
    unset/0/false -> None (off), "1"/true -> ``M2KT_METRICS_DIR`` or cwd,
    anything else -> treated as the target directory."""
    raw = os.environ.get(PLAN_REPORT_ENV, "").strip()
    if not raw or raw.lower() in ("0", "false", "off"):
        return None
    if raw.lower() in ("1", "true", "on"):
        return os.environ.get("M2KT_METRICS_DIR", "") or "."
    return raw


def build_plan_report(memory_plan, accelerator: str, *,
                      mesh_plan=None, n_devices: int | None = None,
                      cost: CostReport | None = None,
                      step_seconds: float | None = None,
                      headroom: float = 0.9,
                      optimizer_slots: int = 2) -> dict:
    """The preflight fit report: the ``MemoryPlan`` (``parallel/
    memory.py``) against the card's budget, the ``MeshPlan`` (``parallel/
    topology.py``, optional), the counted step's roofline and MFU when
    ``cost`` is given, and, over budget, the smallest fsdp re-split that
    would fit. A plain dict, the reference's schema."""
    spec, assumed = chip_spec(accelerator)
    budget = spec.hbm_bytes * headroom
    predicted_total = int(memory_plan.total)
    fits = predicted_total <= budget
    report = {
        "schema": "m2kt-plan-report/v1",
        "accelerator": {
            "requested": accelerator,
            "resolved": normalize_accelerator(accelerator),
            "chip": spec.name,
            "assumed_default": assumed,
            "peak_bf16_flops": spec.peak_bf16_flops,
            "hbm_bytes": spec.hbm_bytes,
            "hbm_bandwidth_bytes_s": spec.hbm_bandwidth,
        },
        "predicted": {
            "params_bytes": int(memory_plan.params),
            "grads_bytes": int(memory_plan.grads),
            "opt_state_bytes": int(memory_plan.opt_state),
            "activations_bytes": int(memory_plan.activations),
            "total_bytes": predicted_total,
            "breakdown": [
                {"leaf": name, "bytes": int(nbytes)}
                for name, nbytes in memory_plan.breakdown
            ],
        },
        "fit": {
            "fits": fits,
            "headroom": headroom,
            "budget_bytes": int(budget),
            "utilization": (predicted_total / budget) if budget else None,
        },
        "verdict": "fit" if fits else "over-budget",
    }
    if mesh_plan is not None:
        report["mesh"] = {
            "describe": mesh_plan.describe(),
            "extents": {
                axis: getattr(mesh_plan.config, axis)
                for axis in type(mesh_plan.config).AXES
            },
            "dcn_dp": mesh_plan.dcn_dp,
            "source": mesh_plan.source,
        }
    if not fits:
        report["suggestion"] = _fsdp_suggestion(
            memory_plan, mesh_plan, n_devices, spec, headroom,
            optimizer_slots)
    if cost is not None:
        report["compiled"] = cost.to_dict()
        report["compiled"]["roofline"] = cost.roofline(spec)
        report["estimated_mfu"] = {
            "roofline_ceiling": cost.mfu_ceiling(spec),
            "achieved": cost.mfu(step_seconds, spec),
            "step_seconds": step_seconds,
        }
        measured_total = cost.peak_hbm_bytes
        drift = None
        if measured_total:
            drift = predicted_total / measured_total
        report["drift"] = {
            "measured_peak_hbm_bytes": measured_total,
            "predicted_over_measured": drift,
            "tolerance_factor": PLAN_DRIFT_TOLERANCE_FACTOR,
            "within_tolerance": (
                None if drift is None else
                1 / PLAN_DRIFT_TOLERANCE_FACTOR <= drift
                <= PLAN_DRIFT_TOLERANCE_FACTOR),
        }
    return report


def _fsdp_suggestion(memory_plan, mesh_plan, n_devices, spec: ChipSpec,
                     headroom: float, optimizer_slots: int) -> dict:
    """The next fsdp re-split that fits, by the planner's own split
    (``topology._memory_min_fsdp``) over the dp x fsdp pool."""
    from move2kube_tpu_torch.parallel.topology import _memory_min_fsdp

    suggestion: dict = {"action": "re-split fsdp"}
    if mesh_plan is not None:
        cfg = mesh_plan.config
        resident = cfg.data * cfg.fsdp
        tensor, current = cfg.tensor, cfg.fsdp
    else:
        resident = max(1, int(n_devices or 1))
        tensor, current = 1, 1
    # params in the plan are per card: scale back to the pool's total
    param_bytes = int(memory_plan.params) * max(1, current)
    fsdp = _memory_min_fsdp(resident, tensor, param_bytes, spec.hbm_bytes,
                            headroom, optimizer_slots)
    suggestion.update({
        "current_fsdp": current,
        "suggested_fsdp": max(fsdp, current),
        "resident_pool": resident,
    })
    if fsdp <= current:
        # state already sharded as far as the pool allows: the overage is
        # activations
        suggestion["action"] = (
            "state fully sharded; reduce batch/sequence or add chips")
    return suggestion


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(value) < 1024 or unit == "GiB":
            return f"{value:.2f} {unit}" if unit != "B" else f"{int(value)} B"
        value /= 1024
    return f"{value:.2f} GiB"


def render_plan_markdown(report: dict) -> str:
    """The report as a short markdown brief (the JSON is for tools)."""
    acc = report.get("accelerator", {})
    pred = report.get("predicted", {})
    fit = report.get("fit", {})
    lines = [
        "# m2kt preflight plan report",
        "",
        f"- **verdict**: {report.get('verdict', '?')}",
        f"- **chip**: {acc.get('chip', '?')}"
        + (" (assumed default)" if acc.get("assumed_default") else "")
        + f" — HBM {_fmt_bytes(acc.get('hbm_bytes'))}, "
          f"peak bf16 {acc.get('peak_bf16_flops', 0) / 1e12:.0f} TFLOP/s",
        f"- **budget**: {_fmt_bytes(fit.get('budget_bytes'))} "
        f"(headroom {fit.get('headroom')})",
        "",
        "| component | bytes/chip |",
        "|---|---|",
    ]
    for key, label in (("params_bytes", "params"), ("grads_bytes", "grads"),
                       ("opt_state_bytes", "optimizer state"),
                       ("activations_bytes", "activations"),
                       ("total_bytes", "**total**")):
        lines.append(f"| {label} | {_fmt_bytes(pred.get(key))} |")
    if report.get("mesh"):
        lines += ["", f"Mesh plan: `{report['mesh']['describe']}`"]
    if report.get("suggestion"):
        s = report["suggestion"]
        lines += ["", f"**Over budget** — {s.get('action')}"]
        if s.get("suggested_fsdp"):
            lines.append(f"Suggested fsdp: {s['current_fsdp']} -> "
                         f"{s['suggested_fsdp']} "
                         f"(pool {s['resident_pool']})")
    est = report.get("estimated_mfu")
    if est:
        ceil = est.get("roofline_ceiling")
        ach = est.get("achieved")
        lines += ["", "Compiled-step estimate: "
                  + (f"MFU ceiling {ceil:.1%}" if ceil is not None
                     else "MFU ceiling unknown")
                  + (f", achieved {ach:.2%}" if ach is not None else "")]
    drift = report.get("drift")
    if drift and drift.get("predicted_over_measured") is not None:
        lines += ["", f"Predicted/measured peak HBM: "
                  f"{drift['predicted_over_measured']:.2f}x "
                  f"(tolerance {drift['tolerance_factor']}x, "
                  f"{'OK' if drift['within_tolerance'] else 'DRIFTED'})"]
    return "\n".join(lines) + "\n"


def write_plan_report(report: dict, out_dir: str | None = None,
                      strict: bool | None = None) -> tuple[str, str] | None:
    """Write ``m2kt-plan-report.json`` and ``.md`` into ``out_dir``
    (default: the ``M2KT_PLAN_REPORT`` directory; None when the knob is
    off), each through a temporary file and a rename. ``strict`` (default
    ``M2KT_PLAN_REPORT_STRICT``) turns an over-budget verdict into a
    SystemExit; otherwise the suggestion goes to stderr."""
    out_dir = out_dir if out_dir is not None else plan_report_dir()
    if out_dir is None:
        return None
    paths = None
    try:
        os.makedirs(out_dir, exist_ok=True)
        json_path = os.path.join(out_dir, "m2kt-plan-report.json")
        md_path = os.path.join(out_dir, "m2kt-plan-report.md")
        for path, payload in ((json_path, json.dumps(
                report, indent=2, sort_keys=True) + "\n"),
                (md_path, render_plan_markdown(report))):
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(payload)
            os.replace(tmp, path)
        paths = (json_path, md_path)
    except OSError:
        pass
    if report.get("verdict") == "over-budget":
        if strict is None:
            strict = os.environ.get(
                PLAN_REPORT_STRICT_ENV, "0").lower() in ("1", "true", "on")
        msg = (f"[m2kt] plan report: predicted "
               f"{report['predicted']['total_bytes'] / 1e9:.2f} GB/chip "
               f"exceeds the {report['fit']['budget_bytes'] / 1e9:.2f} GB "
               f"budget; suggestion: {report.get('suggestion', {})}")
        if strict:
            raise SystemExit(msg)
        import sys

        print(msg, file=sys.stderr, flush=True)
    return paths


# ---------------------------------------------------------------------------
# OOM forensics: memory snapshot sidecar for the flight recorder
# ---------------------------------------------------------------------------

_latest_memory: dict = {}
_mem_lock = threading.Lock()
_mem_flush_installed = False


def mem_snapshot_path() -> str:
    """The memory-snapshot dump: derived from the flight path the same way
    as the span ring, so the supervisor needs no handshake."""
    return tracing.flight_path() + ".mem"


def note_memory_report(report: CostReport) -> None:
    """Remember the latest measured memory so a later death dumps it into
    the flight sidecar."""
    if report.memory:
        with _mem_lock:
            _latest_memory["memory_analysis"] = dict(report.memory)
            _latest_memory["peak_hbm_bytes"] = report.peak_hbm_bytes


def live_buffer_summary(top_n: int = 8) -> dict:
    """The CUDA caching allocator's live allocations
    (``torch.cuda.memory_stats()``): count, total bytes, and the largest
    blocks (the allocator knows no shapes or types: ``"?"``). {} without
    a card or on any failure."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        stats = torch.cuda.memory_stats()
        sizes = sorted((int(block["size"])
                        for segment in torch.cuda.memory_snapshot()
                        for block in segment.get("blocks", ())
                        if block.get("state") == "active_allocated"),
                       reverse=True)
        return {
            "count": int(stats.get("allocation.all.current", 0)),
            "total_bytes": int(stats.get("allocated_bytes.all.current", 0)),
            "top": [{"bytes": b, "shape": "?", "dtype": "?"}
                    for b in sizes[:top_n]],
        }
    except Exception:  # noqa: BLE001 - forensics must never raise
        return {}


def write_memory_snapshot(path: str | None = None) -> str | None:
    """Atomic dump of the latest measured memory and a live-buffer summary
    for the supervisor's flight recorder. Best-effort by design: it runs
    on dying-process paths."""
    path = path or mem_snapshot_path()
    with _mem_lock:
        doc = dict(_latest_memory)
    doc["live_buffers"] = live_buffer_summary()
    doc["written_unix"] = time.time()
    doc["pid"] = os.getpid()
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def install_memory_snapshot(path: str | None = None) -> None:
    """Dump the memory snapshot on every exit path that runs interpreter
    teardown, by the same ``threading._register_atexit`` route as
    ``tracing.install_ring_flush``. Once per process."""
    global _mem_flush_installed
    if _mem_flush_installed:
        return
    _mem_flush_installed = True

    def _flush() -> None:
        try:
            write_memory_snapshot(path)
        except Exception:  # noqa: BLE001 - dying process, best effort
            pass

    register = getattr(threading, "_register_atexit", None)
    if register is None:
        import atexit

        atexit.register(_flush)
    else:
        register(_flush)
