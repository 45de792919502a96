"""The port's emitter (``move2kube_tpu_torch/containerizer/cuda_emit.py``)
against the JAX package's ``jax_emit.emit_container``.

Every sample under ``samples/gpu-training/`` is planned with the JAX
planner (the ``--qa-skip`` defaults: no QA engine runs), and each GPU
service goes through both emitters. They must pick the same family, the
same train-or-serve decision, the same baked knobs and the same file set
(the port's programs named ``*_gpu.py``). The payload vendors exactly a
walk of ``move2kube_tpu_torch/`` (``.py``, ``.cu``, ``.cuh``), no file of
it imports JAX, flax, optax, jinja2 or the JAX package, its programs
compile, rendering needs no jinja2, and ``chip_smoke.py``'s stand-in
services render what the planner's services render.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from move2kube_tpu.containerizer import jax_emit  # noqa: E402
from move2kube_tpu.engine.planner import create_plan  # noqa: E402
from move2kube_tpu.parallel.mesh import infer_mesh_config  # noqa: E402
from move2kube_tpu_torch.containerizer import cuda_emit  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SAMPLES = REPO / "samples" / "gpu-training"
SAMPLE_DIRS = sorted(p.name for p in SAMPLES.iterdir() if p.is_dir())
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "jinja2", "move2kube_tpu")
PROGRAMS = {"train_tpu.py": "train_gpu.py", "serve_tpu.py": "serve_gpu.py"}

# the port's baked constant -> the env knob whose default the JAX program
# bakes (``os.environ.get("M2KT_X", "<default>")``, ``setdefault`` or
# ``os.environ.get("M2KT_X", "") or "<default>"``)
TRAIN_KNOBS = {"STEPS_DEFAULT": "M2KT_STEPS", "LR_DEFAULT": "M2KT_LR",
               "GRAD_ACCUM_DEFAULT": "M2KT_GRAD_ACCUM",
               "MOE_EXPERTS": "M2KT_MOE_EXPERTS",
               "NUM_SLICES_DEFAULT": "M2KT_NUM_SLICES",
               "METRICS_PORT_DEFAULT": "M2KT_METRICS_PORT",
               "NUMERICS": "M2KT_NUMERICS"}
SERVE_KNOBS = {"SERVE_PORT_DEFAULT": "M2KT_SERVE_PORT",
               "SERVE_MAX_BATCH_DEFAULT": "M2KT_SERVE_MAX_BATCH",
               "SERVE_MAX_SEQ_DEFAULT": "M2KT_SERVE_MAX_SEQ",
               "SERVE_KV_BLOCK_DEFAULT": "M2KT_KV_BLOCK_SIZE",
               "SERVE_QUANT_DEFAULT": "M2KT_SERVE_QUANT",
               "SERVE_KERNELS_DEFAULT": "M2KT_SERVE_KERNELS",
               "SPEC_K_DEFAULT": "M2KT_SPEC_K",
               "SERVE_ASYNC_DEFAULT": "M2KT_ASYNC_DECODE",
               "SERVE_SUBSTEPS_DEFAULT": "M2KT_DECODE_SUBSTEPS",
               "SLO_TTFT_P95": "M2KT_SLO_TTFT_P95_S",
               "SLO_AVAILABILITY": "M2KT_SLO_AVAILABILITY",
               "SLO_MAX_TENANTS": "M2KT_OBS_MAX_TENANTS",
               "SCHED_PRIORITIES": "M2KT_SCHED_PRIORITIES",
               "SCHED_QUOTAS": "M2KT_SCHED_QUOTAS",
               "SCHED_CHUNK_PREFILL": "M2KT_SCHED_CHUNK_PREFILL",
               "SCHED_MAX_LORAS": "M2KT_SCHED_MAX_LORAS",
               "AUTOSCALE_INTERVAL": "M2KT_AUTOSCALE_INTERVAL_S",
               "NUMERICS": "M2KT_NUMERICS",
               "QUANT_AUDIT_RATE": "M2KT_QUANT_AUDIT_RATE",
               "METRICS_PORT_DEFAULT": "M2KT_METRICS_PORT",
               "WEIGHTS_PORT_DEFAULT": "M2KT_WEIGHTS_PORT"}


def _jax_defaults(text: str) -> dict:
    """Each ``M2KT_*`` knob's default as the rendered JAX program bakes
    it."""
    out = {}
    pat = re.compile(r'"(M2KT_[A-Z0-9_]+)",\s*\n?\s*"([^"]*)"\)'
                     r'(?:\s*\n?\s*or\s+"([^"]*)")?')
    for name, default, alt in pat.findall(text):
        out[name] = alt if default == "" and alt else default
    for name, alt in re.findall(
            r'os\.environ\.get\("(M2KT_[A-Z0-9_]+)", ""\)\s*\n?\s*or "([^"]*)"',
            text):
        out[name] = alt
    return out


@pytest.fixture(scope="module")
def emitted():
    """(sample, service name) -> (JAX container, port container), one
    planner pass per sample."""
    out = {}
    for d in SAMPLE_DIRS:
        plan = create_plan(str(SAMPLES / d))
        for name, opts in sorted(plan.services.items()):
            for svc in opts:
                if svc.accelerator is None:
                    continue
                port = cuda_emit.emit_container(svc)
                out[(d, name)] = (jax_emit.emit_container(svc, plan), port)
    assert {d for d, _ in out} == set(SAMPLE_DIRS)
    return out


def _program(files: dict) -> str:
    (name,) = [p for p in PROGRAMS if p in files]
    return name


@pytest.mark.parametrize("sample", SAMPLE_DIRS)
def test_same_family_decision_knobs_and_files(emitted, sample):
    for (d, _), (jc, pc) in emitted.items():
        if d != sample:
            continue
        jprog = _program(jc.new_files)
        pprog = PROGRAMS[jprog]
        # the same train-or-serve decision and the same file set
        jset = {PROGRAMS.get(f, f) for f in jc.new_files
                if not f.startswith("move2kube_tpu/")}
        pset = {f for f in pc.new_files
                if not f.startswith("move2kube_tpu_torch/")}
        assert pset == jset
        assert pc.image_names == jc.image_names
        assert pc.exposed_ports == jc.exposed_ports
        text = jc.new_files[jprog]
        baked = pc.baked[pprog]
        # the same family (HF GPT-2 fine-tunes become gpt2)
        family = re.search(r"model family=(\w+)", text).group(1)
        assert baked["FAMILY"] == family
        assert pc.baked["port_weights.py"]["FAMILY"] == family
        assert f'family = "{family}"' in jc.new_files["port_weights.py"]
        defaults = _jax_defaults(text)
        knobs = SERVE_KNOBS if pprog == "serve_gpu.py" else TRAIN_KNOBS
        for const, env in knobs.items():
            if env not in defaults:
                # the JAX trainer reads the expert count in its Llama
                # branch only
                assert (const, baked[const]) == ("MOE_EXPERTS", 0)
                continue
            assert str(baked[const]) == defaults[env], (const, env)
        if pprog == "train_gpu.py":
            prec = re.search(r'from_env\(default="(\w[\w-]*)"\)', text)
            assert baked["PRECISION_DEFAULT"] == prec.group(1)
            # the degrees the JAX trainer hands its planner, laid on the
            # detected device count, are the port's baked mesh
            deg = {k: int(re.search(rf"{k}=(\d+),", text).group(1))
                   for k in ("zero_stage", "tensor_parallel",
                             "seq_parallel", "pipeline_parallel",
                             "expert_parallel")}
            mesh = infer_mesh_config(max(1, int(re.search(
                r"gpus=(\d+)", text).group(1))), **deg)
            assert tuple(baked["MESH"].values()) == mesh.dims()
            assert list(baked["MESH"]) == ["data", "fsdp", "pipe", "tensor",
                                           "seq", "expert"]
            head = re.search(r"mesh\ndata=(\d+) fsdp=(\d+) tensor=(\d+) "
                             r"seq=(\d+)\.", text).groups()
            assert [baked["MESH"][a] for a in ("data", "fsdp", "tensor",
                                               "seq")] == list(map(int, head))
            assert baked["GPU_COUNT"] == int(re.search(r"gpus=(\d+)",
                                                       text).group(1))
        assert baked["SOURCE_ENTRYPOINT"] == re.search(
            r"Source workload: (\S+)", text).group(1)


def test_samples_cover_both_programs_and_every_family(emitted):
    progs = {_program(jc.new_files) for jc, _ in emitted.values()}
    assert progs == set(PROGRAMS)
    families = {next(iter(pc.baked.values()))["FAMILY"]
                for _, pc in emitted.values()}
    assert {"resnet", "bert", "gpt2", "llama", "unet"} <= families


def _walk_port() -> dict:
    root = REPO / "move2kube_tpu_torch"
    out = {}
    for path in root.rglob("*"):
        rel = path.relative_to(REPO)
        if (path.is_file() and path.suffix in (".py", ".cu", ".cuh")
                and "__pycache__" not in rel.parts
                and "build" not in rel.parts):
            out[rel.as_posix()] = path.read_text()
    return out


def test_vendored_tree_is_the_whole_port(emitted):
    walk = _walk_port()
    assert any(k.endswith(".cu") for k in walk)
    assert any(k.endswith(".cuh") for k in walk)
    for _, pc in emitted.values():
        vendored = {k: v for k, v in pc.new_files.items()
                    if k.startswith("move2kube_tpu_torch/")}
        assert vendored == walk
        assert not any(k.startswith("tests/") for k in pc.new_files)


def _roots(text: str, name: str):
    for node in ast.walk(ast.parse(text, filename=name)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_payload_imports_nothing_of_jax_and_programs_compile(emitted):
    for (d, _), (_, pc) in emitted.items():
        for name, text in pc.new_files.items():
            if not name.endswith(".py"):
                continue
            bad = [r for r in _roots(text, name) if r in FORBIDDEN]
            assert not bad, (d, name, bad)
            compile(text, name, "exec")
        reqs = pc.new_files["requirements.txt"].split()
        assert reqs == ["torch", "numpy"]
        docker = pc.new_files["Dockerfile"]
        assert docker.startswith("FROM nvidia/cuda:") and "devel" in docker
        assert "M2KT_COMPILE_CACHE_DIR=/app/.m2kt-cache" in docker
        if "serve_gpu.py" in pc.new_files:
            assert "M2KT_PREWARM_DIR=" in docker
            assert 'CMD ["python3", "serve_gpu.py"]' in docker
        else:
            assert "move2kube_tpu_torch.resilience.supervisor" in docker
            assert "M2KT_PREWARM_DIR" not in docker


def test_unrendered_templates_are_plain_python():
    """Each template runs as it stands: its baked block holds defaults."""
    for name in ("train_gpu.py", "serve_gpu.py", "port_weights.py"):
        text = (REPO / "move2kube_tpu_torch/assets/cuda" / name).read_text()
        compile(text, name, "exec")
        assert text.count("# m2kt:baked-begin") == 1
        with pytest.raises(ValueError):
            cuda_emit.render(text.replace("# m2kt:baked-end", "#"), {})


def _stand_in_files(root: str) -> dict:
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return {kind: cuda_emit.emit_container(svc).new_files
            for kind, svc in chip_smoke.emit_services(root).items()}


def test_chip_smoke_stand_ins_render_the_planner_files(emitted):
    stand = _stand_in_files(str(REPO))
    _, train = emitted[("llama3-8b", "llama3-8b")]
    _, serve = emitted[("llama-serve", "llama-serve")]
    assert stand["train"] == train.new_files
    assert stand["serve"] == serve.new_files


def test_rendering_needs_no_jinja2(tmp_path):
    code = (
        "import sys; sys.modules['jinja2'] = None\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "from move2kube_tpu_torch.containerizer import cuda_emit\n"
        "for kind, svc in chip_smoke.emit_services(sys.argv[1]).items():\n"
        "    cuda_emit.write_payload(cuda_emit.emit_container(svc), kind)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        f"and m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert (tmp_path / "train" / "train_gpu.py").is_file()
    assert (tmp_path / "serve" / "serve_gpu.py").is_file()
    assert (tmp_path / "train" / "move2kube_tpu_torch" / "csrc"
            / "flash_fwd.cu").is_file()
    assert os.access(tmp_path / "train" / "llama3-8b-docker-build.sh",
                     os.X_OK)


def test_answers_override_the_defaults():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    svc = chip_smoke.emit_services(str(REPO))["serve"]
    c = cuda_emit.emit_container(svc, {"serve_quant": "int8-kv",
                                       "spec_k": 4})
    baked = c.baked["serve_gpu.py"]
    assert baked["SERVE_QUANT_DEFAULT"] == "int8-kv"
    assert baked["SPEC_K_DEFAULT"] == 4
    assert "SERVE_QUANT_DEFAULT = 'int8-kv'" in c.new_files["serve_gpu.py"]
