"""The port's emitted trainer (``train_gpu.py``) for the families the JAX
comparison in ``tests/test_torch_emitted_train.py`` does not cover, and
its refusals, each run from the payload the port's emitter renders for a
JAX planner's service, in a subprocess on the CPU.

BERT, ResNet, the UNet, the generic scaffold and the MoE Llama each run
2 steps to ``[m2kt] done``. A 2-step run then a 4-step one resumes from
step 2 (the JAX package's ``tests/test_gpu2tpu_e2e.py:101-128``); an
injected ``exit`` under the port's supervisor is retried to ``done``. On
one device the baked mesh of more than one device and an
``M2KT_MESH_*`` override whose product is not 1 each plan and train as
the JAX emitted trainer does on one device, printing its plan line. A
world of two slices or two hosts that names no rendezvous exits 2 at
once, where the JAX trainer fails to start its distributed world; ring
attention, which the JAX trainer runs, exits 2 naming ROADMAP Queue 1
item 9d. Worlds of two ranks are in ``tests/test_torch_dist_emitted.py``.
With no card and no ``M2KT_DEVICE=cpu`` the program exits non-zero. Every subprocess runs in ``tmp_path`` with an env
holding no ``M2KT_*`` key but the ones it sets, under a timeout.
"""

import json
import sys
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.containerizer import jax_emit  # noqa: E402
from move2kube_tpu_torch.containerizer import cuda_emit  # noqa: E402
from tests.test_torch_emitted_train import (  # noqa: E402
    LLAMA_TINY,
    MESH_ONE,
    _env,
    _port_payload,
    _run,
    _service,
    _write,
    run_jax_trainer,
    run_port_trainer,
)

FAMILY_RUNS = {
    "bert": ("bert", {"M2KT_VOCAB": 64, "M2KT_LAYERS": 2, "M2KT_HEADS": 2,
                      "M2KT_DMODEL": 16, "M2KT_MLP_DIM": 32,
                      "M2KT_SEQ_LEN": 16, "M2KT_MAX_LEN": 32,
                      "M2KT_BATCH_PER_DEVICE": 2}),
    "resnet": ("resnet", {"M2KT_IMAGE_SIZE": 32, "M2KT_NUM_CLASSES": 10,
                          "M2KT_BATCH_PER_DEVICE": 2}),
    "unet": ("ddpm", {"M2KT_IMAGE_SIZE": 16, "M2KT_BASE_CHANNELS": 16,
                      "M2KT_CHANNEL_MULTS": "1,2", "M2KT_RES_BLOCKS": 1,
                      "M2KT_NORM_GROUPS": 4, "M2KT_DIFFUSION_STEPS": 100,
                      "M2KT_BATCH_PER_DEVICE": 2}),
    "moe": ("llama-moe", dict(LLAMA_TINY, M2KT_SEQ_LEN=16)),
}


def _generic_service():
    return SimpleNamespace(
        service_name="scaffold", image="", source_artifacts={},
        containerization_target_options=["unknown-net"],
        accelerator=SimpleNamespace(
            gpu_count=1, frameworks=["torch"], distributed_backend="",
            parallelism={}, model_family="", entrypoint="train.py",
            num_slices=1, serving=False, serving_port=0))


@pytest.mark.parametrize("family", ["bert", "resnet", "unet", "generic",
                                    "moe"])
def test_other_families_train_to_done(tmp_path, family):
    if family == "generic":
        svc, knobs = _generic_service(), {"M2KT_FEATURE_DIM": 16,
                                          "M2KT_NUM_CLASSES": 4}
    else:
        sample, knobs = FAMILY_RUNS[family]
        svc, _ = _service(sample)
    payload = _port_payload(svc, tmp_path)
    baked = cuda_emit.emit_container(svc).baked["train_gpu.py"]
    assert baked["FAMILY"] == {"moe": "llama", "unet": "unet"}.get(
        family, family)
    if family == "moe":
        assert baked["MOE_EXPERTS"] == 8
    run = run_port_trainer(payload, _env(tmp_path, M2KT_STEPS=2,
                                         **MESH_ONE, **knobs))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[m2kt] done steps=2" in run.stdout
    assert "goodput=" in run.stdout


def test_resume_from_step_2(tmp_path):
    svc, _ = _service("llama3-8b")
    payload = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_CKPT_DIR=tmp_path / "ckpt", M2KT_CKPT_EVERY=1,
               **MESH_ONE, **LLAMA_TINY)
    first = run_port_trainer(payload, dict(env, M2KT_STEPS="2"))
    assert first.returncode == 0, first.stderr[-3000:]
    assert "[m2kt] done" in first.stdout and "resumed" not in first.stdout
    second = run_port_trainer(payload, dict(env, M2KT_STEPS="4"))
    assert second.returncode == 0, second.stderr[-3000:]
    assert "[m2kt] resumed from step 2" in second.stdout
    assert "[m2kt] done steps=4" in second.stdout


def test_injected_exit_is_retried_under_the_supervisor(tmp_path):
    svc, _ = _service("llama3-8b")
    payload = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_CKPT_DIR=tmp_path / "ckpt", M2KT_CKPT_EVERY=1,
               M2KT_STEPS=4, M2KT_FAULT_STEP=3, M2KT_FAULT_KIND="exit",
               M2KT_FAULT_MARKER=tmp_path / "fired", M2KT_RETRY_MAX=2,
               M2KT_RETRY_BACKOFF_S="0.1",
               M2KT_EXIT_FILE=tmp_path / "exit.json", **MESH_ONE,
               **LLAMA_TINY)
    run = run_port_trainer(payload, env, supervised=True)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "[m2kt] FAULT: injected exit at step 3" in run.stdout
    assert "[m2kt] resumed from step 2" in run.stdout
    assert "[m2kt] done steps=4" in run.stdout
    summary = json.loads((tmp_path / "exit.json").read_text())
    assert summary["exit_class"] == "ok"
    assert [a["class"] for a in summary["attempts"]] == ["retryable", "ok"]


@pytest.mark.parametrize("knobs,source", [
    ({}, "topology=1 layout=[] source=single-chip"),  # baked: fsdp=64
    (dict(MESH_ONE, M2KT_MESH_TENSOR="2"),
     "topology=1 layout=[] source=single-chip"),
    (MESH_ONE, "topology=- layout=[] source=env-mesh"),
    # ring attention with no seq axis runs flash, as in the JAX trainer
    (dict(MESH_ONE, M2KT_ATTN_IMPL="ring"),
     "topology=- layout=[] source=env-mesh"),
])
def test_one_device_plans_and_trains_as_the_jax_trainer(tmp_path, knobs,
                                                        source):
    """The JAX emitted trainer and the port's, one step on one CPU device:
    both exit 0 at ``done`` and print the same one-device plan."""
    svc, plan = _service("llama3-8b")
    jdir = _write(jax_emit.emit_container(svc, plan).new_files,
                  tmp_path / "jax")
    pdir = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_STEPS=1, **LLAMA_TINY, **knobs)
    plans = []
    for run in (run_jax_trainer(jdir, env), run_port_trainer(pdir, env)):
        assert run.returncode == 0, run.stderr[-3000:]
        assert "[m2kt] done steps=1" in run.stdout
        plans.append([x for x in run.stdout.splitlines()
                      if x.startswith("[m2kt] devices=")])
    assert plans[0] == plans[1] == [
        f"[m2kt] devices=1 mesh=1x1x1x1x1x1 {source}"]


@pytest.mark.parametrize("knobs,jax_trains,says", [
    (dict(MESH_ONE, M2KT_NUM_SLICES="2"), False, "names no rendezvous"),
    (dict(MESH_ONE, M2KT_NUM_HOSTS="2"), False, "names no rendezvous"),
])
def test_more_than_one_device_exits_2_naming_item_9(tmp_path, knobs,
                                                    jax_trains, says):
    """The port's trainer refuses with exit 2, before any process group
    waits for an absent peer; the JAX trainer, on the same one CPU
    device, fails to start a world of two processes without a
    coordinator."""
    svc, plan = _service("llama3-8b")
    payload = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_STEPS=1, **LLAMA_TINY, **knobs)
    t0 = time.monotonic()
    run = run_port_trainer(payload, env)
    assert run.returncode == 2, run.stderr[-2000:]
    assert says in run.stdout
    assert time.monotonic() - t0 < 60
    assert "[m2kt] done" not in run.stdout
    if not jax_trains:
        jdir = _write(jax_emit.emit_container(svc, plan).new_files,
                      tmp_path / "jax")
        jrun = run_jax_trainer(jdir, env)
        assert jrun.returncode != 0
        assert "[m2kt] done" not in jrun.stdout


def test_no_card_and_no_cpu_knob_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    svc, _ = _service("llama3-8b")
    payload = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_STEPS=1, **MESH_ONE, **LLAMA_TINY)
    run = _run(payload, [sys.executable, "train_gpu.py"], env)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
    assert "[m2kt] done" not in run.stdout
