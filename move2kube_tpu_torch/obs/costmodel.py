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

Not ported: the preflight plan report (``build_plan_report``,
``write_plan_report``), which comes with ``parallel/memory.py`` (ROADMAP
Queue 1 item 9), and the XLA introspection (``analyze_compiled``,
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
