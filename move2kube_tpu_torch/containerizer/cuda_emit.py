"""The port's emitter: the image payload for a detected GPU workload, with
the PyTorch port in it.

:func:`emit_container` is the counterpart of the JAX package's
``containerizer/jax_emit.emit_container``: for a planned GPU service it
picks the same model family, the same train-or-serve decision and the
same parallelism degrees, and returns the files of an image that runs
them on one CUDA card:

- ``train_gpu.py`` (a trainer for the family) or, for a detected
  inference server of a decoder LM, ``serve_gpu.py`` (the
  continuous-batching server), rendered from ``assets/cuda``;
- ``port_weights.py``, which turns the workload's torch checkpoint into
  the trainer's step-0 checkpoint;
- the vendored port: every ``.py``, ``.cu`` and ``.cuh`` file of
  ``move2kube_tpu_torch/`` (the kernels build from their sources with
  ``nvcc`` at first use);
- a CUDA ``Dockerfile``, ``requirements.txt`` and ``<svc>-docker-build.sh``.

The service is duck-typed: anything with the attributes of the JAX
package's ``PlanService`` (``service_name``, ``image``,
``containerization_target_options``, ``source_artifacts``) and of its
``AcceleratorInfo`` (``accelerator``: ``gpu_count``, ``parallelism``,
``model_family``, ``serving``, ...). ``answers`` holds the choices the
JAX emitter asks its QA engine for; each missing one takes the default
that engine answers under ``--qa-skip`` (:func:`default_answers`).

Rendering uses the standard library alone: each template is plain Python
that runs as it stands, and the emitter rewrites the one block of
constants between its ``m2kt:baked-begin`` and ``m2kt:baked-end`` lines,
each value written with ``repr``. The Kubernetes manifests are the
translator's business, not the image's, and are not written here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re

from move2kube_tpu_torch.parallel.mesh import infer_mesh_config

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(PKG_ROOT, "assets", "cuda")
VENDORED_SUFFIXES = (".py", ".cu", ".cuh")

# families accepted as containerization target options; detection reports
# "gpt" and the no-MoE refinement below picks gpt2
KNOWN_FAMILIES = ("resnet", "bert", "llama", "gpt", "gpt2", "unet")
LM_FAMILIES = ("llama", "gpt", "gpt2")

REQUIREMENTS = """torch
numpy
"""

DOCKER_BUILD_SH = """#!/bin/sh
# Build the container image for service {service_name}.
# Run from the directory containing this script.
cd "$(dirname "$0")"
docker build -f {dockerfile_name} -t {image_name} {context}
"""

# in-image kernel build cache (M2KT_COMPILE_CACHE_DIR; a mounted volume
# survives pod restarts), as the Dockerfile sets it
COMPILE_CACHE_DIR = "/app/.m2kt-cache"

_BAKED = re.compile(r"^# m2kt:baked-begin[^\n]*\n.*?^# m2kt:baked-end\n",
                    re.S | re.M)


@dataclasses.dataclass
class EmittedContainer:
    """What :func:`emit_container` returns: the image's name, its files
    (path in the build context -> text) and the ports it exposes, plus
    the constants baked into each rendered program (file -> name ->
    value)."""
    image_names: list
    new_files: dict
    exposed_ports: list
    baked: dict


def _dns_sanitize(s: str, maxlen: int) -> str:
    s = s.lower()
    s = re.sub(r"[^a-z0-9\-.]", "-", s)
    s = re.sub(r"\.+", ".", s)
    s = s.strip("-.")
    if len(s) > maxlen:
        digest = hashlib.sha256(s.encode()).hexdigest()[:8]
        s = s[: maxlen - 9].rstrip("-.") + "-" + digest
    return s or "app"


def make_dns_label(s: str) -> str:
    """A DNS-1123 label (lowercase alnum and '-', at most 63 chars), as
    the JAX package's ``utils/common.make_dns_label`` makes it."""
    return _dns_sanitize(_dns_sanitize(s, 253).replace(".", "-"), 63)


def default_answers(family: str, serving: bool) -> dict:
    """What the JAX emitter's QA problems answer under ``--qa-skip``."""
    return {
        "precision": ("bf16" if serving or family in ("llama", "gpt", "gpt2",
                                                      "bert") else "fp32"),
        "grad_accum": 1,
        "metrics_port": 9090,
        "numerics": "1", "quant_audit_rate": "0.01",
        "serve_max_batch": 8, "serve_max_seq": 2048, "serve_kv_block": 16,
        "serve_quant": "off", "serve_kernels": "auto", "spec_k": 0,
        "serve_async": "auto", "serve_substeps": 1,
        "slo_ttft_p95": 0.5, "slo_availability": 0.99, "slo_max_tenants": 8,
        "sched_priorities": "", "sched_quotas": "",
        "sched_chunk_prefill": 0, "sched_max_loras": 0,
        "autoscale_interval": 15,
    }


def render(template: str, constants: dict) -> str:
    """``template`` with its baked block replaced by ``constants``, one
    ``NAME = repr(value)`` line each."""
    lines = "".join(f"{k} = {v!r}\n" for k, v in constants.items())
    block = f"# m2kt:baked-begin (rendered by the emitter)\n{lines}# m2kt:baked-end\n"
    out, n = _BAKED.subn(lambda _m: block, template)
    if n != 1:
        raise ValueError("template has no single m2kt:baked block")
    return out


def render_dockerfile(serve: bool, serve_port: int) -> str:
    """``assets/cuda/Dockerfile`` with its ``serve`` or ``train`` section
    kept (marked ``# [serve]``/``# [train]`` ... ``# [end]``)."""
    keep, out, section = "serve" if serve else "train", [], None
    with open(os.path.join(ASSETS, "Dockerfile"), encoding="utf-8") as f:
        for line in f:
            tag = line.strip()
            if tag in ("# [serve]", "# [train]"):
                section = tag[3:-1]
            elif tag == "# [end]":
                section = None
            elif section in (None, keep):
                out.append(line.replace("$serve_port", str(serve_port)))
    return "".join(out)


def vendored_files() -> dict:
    """Every ``.py``, ``.cu`` and ``.cuh`` file under the port's package,
    by its path in the image."""
    files = {}
    for dirpath, dirnames, filenames in os.walk(PKG_ROOT):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("build", "__pycache__"))
        for fname in sorted(filenames):
            if not fname.endswith(VENDORED_SUFFIXES):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, os.path.dirname(PKG_ROOT))
            with open(path, encoding="utf-8") as f:
                files[rel.replace(os.sep, "/")] = f.read()
    return files


def _entrypoint(service, acc) -> str:
    entry = getattr(acc, "entrypoint", "") or ""
    if entry and os.path.isabs(entry):
        srcs = (getattr(service, "source_artifacts", None) or {}).get(
            "SourceDirectories", [])
        root = os.path.abspath(srcs[0]) if srcs else ""
        if root and os.path.abspath(entry).startswith(root + os.sep):
            entry = os.path.relpath(entry, root)
        else:
            entry = os.path.basename(entry)
    return entry or "(unknown)"


def _asset(name: str) -> str:
    with open(os.path.join(ASSETS, name), encoding="utf-8") as f:
        return f.read()


def emit_container(service, answers: dict | None = None) -> EmittedContainer:
    """The image payload for ``service`` (see the module docstring)."""
    acc = service.accelerator
    opts = getattr(service, "containerization_target_options", None) or []
    family = (opts[0] if opts else getattr(acc, "model_family", "")) \
        or "generic"
    if family not in KNOWN_FAMILIES:
        family = "generic"
    name = make_dns_label(service.service_name)
    # only the decoder-LM families have a serving engine; anything else
    # falls back to the training path
    serving = bool(getattr(acc, "serving", False)) and family in LM_FAMILIES
    knobs = default_answers(family, serving)
    knobs.update(answers or {})
    par = dict(getattr(acc, "parallelism", None) or {})
    gpu_count = max(1, int(getattr(acc, "gpu_count", 1) or 1))
    # MoE exists only in the decoder-LM family
    moe_experts = par.get("experts", 0) if family in ("llama", "gpt") else 0
    pp, zero = par.get("pp", 1), par.get("zero_stage", 0)
    # detected pipeline parallelism stays a pipe axis without ZeRO (the
    # staged trainers), else folds into fsdp; on the pipe path tp/sp fold
    # into data parallelism
    use_pipe = (family in LM_FAMILIES and pp > 1 and zero < 2
                and not moe_experts and gpu_count % pp == 0)
    degrees = {
        "zero_stage": zero if use_pipe else max(zero, 2 if pp > 1 else 0),
        "tensor_parallel": 1 if use_pipe else par.get("tp", 1),
        "seq_parallel": 1 if use_pipe else par.get("sp", 1),
        "pipeline_parallel": pp if use_pipe else 1,
        "expert_parallel": par.get("ep", 1) if moe_experts else 1,
    }
    mesh = infer_mesh_config(gpu_count, **degrees)
    # HF GPT-2 fine-tunes (family gpt) emit the true GPT-2 architecture;
    # only MoE gpt workloads keep the Llama-class trainer
    emit_family = "gpt2" if family == "gpt" and not moe_experts else family
    image_name = getattr(service, "image", "") or f"{name}:latest"
    serve_port = getattr(acc, "serving_port", 0) or 8080
    num_slices = max(1, int(getattr(acc, "num_slices", 1) or 1))
    files, baked = {}, {}
    if serving:
        program = "serve_gpu.py"
        baked[program] = {
            "SOURCE_ENTRYPOINT": _entrypoint(service, acc),
            "FAMILY": emit_family,
            "SERVE_PORT_DEFAULT": serve_port,
            "SERVE_MAX_BATCH_DEFAULT": knobs["serve_max_batch"],
            "SERVE_MAX_SEQ_DEFAULT": knobs["serve_max_seq"],
            "SERVE_KV_BLOCK_DEFAULT": knobs["serve_kv_block"],
            "SERVE_QUANT_DEFAULT": knobs["serve_quant"],
            "SERVE_KERNELS_DEFAULT": knobs["serve_kernels"],
            "SPEC_K_DEFAULT": knobs["spec_k"],
            "SERVE_ASYNC_DEFAULT": knobs["serve_async"],
            "SERVE_SUBSTEPS_DEFAULT": knobs["serve_substeps"],
            "SLO_TTFT_P95": knobs["slo_ttft_p95"],
            "SLO_AVAILABILITY": knobs["slo_availability"],
            "SLO_MAX_TENANTS": knobs["slo_max_tenants"],
            "SCHED_PRIORITIES": knobs["sched_priorities"],
            "SCHED_QUOTAS": knobs["sched_quotas"],
            "SCHED_CHUNK_PREFILL": knobs["sched_chunk_prefill"],
            "SCHED_MAX_LORAS": knobs["sched_max_loras"],
            "AUTOSCALE_INTERVAL": knobs["autoscale_interval"],
            "NUMERICS": knobs["numerics"],
            "QUANT_AUDIT_RATE": knobs["quant_audit_rate"],
            "COMPILE_CACHE_DIR": COMPILE_CACHE_DIR,
            "METRICS_PORT_DEFAULT": knobs["metrics_port"],
            # the fleet wiring overrides per pod via M2KT_WEIGHTS_PORT
            "WEIGHTS_PORT_DEFAULT": 8981,
        }
    else:
        program = "train_gpu.py"
        baked[program] = {
            "SOURCE_ENTRYPOINT": _entrypoint(service, acc),
            # sorted: the detector reports them in no fixed order
            "FRAMEWORKS": ",".join(sorted(getattr(acc, "frameworks", None)
                                          or [])) or "unknown",
            "BACKEND": getattr(acc, "distributed_backend", "") or "",
            "GPU_COUNT": gpu_count,
            "FAMILY": emit_family,
            "MESH": dict(zip(("data", "fsdp", "pipe", "tensor", "seq",
                              "expert"), mesh.dims())),
            # what the trainer's planner lays over the world it starts
            "DEGREES": degrees,
            # the JAX emitter's topology default, which its planner reads
            # on one device
            "TOPOLOGY": getattr(acc, "tpu_topology", "") or "1x1",
            "NUM_SLICES_DEFAULT": num_slices,
            "PRECISION_DEFAULT": knobs["precision"],
            "GRAD_ACCUM_DEFAULT": max(1, int(knobs["grad_accum"])),
            "MOE_EXPERTS": moe_experts,
            "NUMERICS": knobs["numerics"],
            "COMPILE_CACHE_DIR": COMPILE_CACHE_DIR,
            "METRICS_PORT_DEFAULT": knobs["metrics_port"],
            "STEPS_DEFAULT": 100,
            "LR_DEFAULT": (3e-4 if family in LM_FAMILIES
                           else 1e-4 if family == "unet" else 1e-3),
        }
    baked["port_weights.py"] = {"FAMILY": emit_family}
    for fname, constants in baked.items():
        files[fname] = render(_asset(fname), constants)
    files.update(vendored_files())
    files["Dockerfile"] = render_dockerfile(serving, serve_port)
    files["requirements.txt"] = REQUIREMENTS
    files[f"{name}-docker-build.sh"] = DOCKER_BUILD_SH.format(
        service_name=name, dockerfile_name="Dockerfile",
        image_name=image_name, context=".")
    return EmittedContainer(image_names=[image_name], new_files=files,
                            exposed_ports=[], baked=baked)


def write_payload(container: EmittedContainer, out_dir: str) -> str:
    """Write ``container``'s files under ``out_dir``; returns it."""
    for rel, text in container.new_files.items():
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        if rel.endswith((".sh", "_gpu.py", "port_weights.py")):
            os.chmod(path, 0o755)
    return out_dir
