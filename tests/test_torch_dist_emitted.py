"""The port's emitted trainer (``train_gpu.py``) in a world of two ranks on
the CPU (``M2KT_DEVICE=cpu M2KT_FORCE_DEVICES=2``: the pod's process
starts two gloo ranks), rendered from the JAX planner's services of the
samples whose baked mesh is pure data parallelism (gpt2, bert and resnet,
data=8), at tiny widths, 10 steps.

- Each prints the JAX trainer's plan line for two devices with
  ``layout=[]`` (``devices=2 mesh=2x1x1x1x1x1 ...``) and reaches
  ``[m2kt] done``; only rank 0 prints.
- Its step-10 loss (4 decimals) matches the JAX emitted trainer on one
  device at twice the per-device batch, the same global batch of the same
  ``default_rng(i)`` rows, within ``LOSS_REL``: GPT-2 and BERT, both sides
  starting from one tiny HF state dict through their own
  ``port_weights.py``. ResNet-50 is not: its BatchNorm over a global
  batch of 4 images at 32 pixels (the last stage normalises 4 values a
  channel) turns the rounding of the sums into the loss. Measured with the
  port's own step from the same seed, fp32, a world of 2 against one:
  2.49298 and 2.49345 at step 1, 2.84937 and 2.28216 at step 2 (1.6e-6
  and 0.6 % apart at 16 images of 64 pixels). Its data-parallel step is
  held to the JAX one and to the port's own on ``tests/
  test_torch_families.py``'s batches in ``tests/test_torch_dp_steps.py``;
  here it trains to ``done`` with a finite loss.
- The llama3-8b sample's world of two (fsdp=2) is
  ``tests/test_torch_dist_emitted_fsdp.py``'s, on this file's helpers.
- A sample whose plan for two devices has an axis the port does not run
  yet (gpt2-pp's pipe axis) exits 2 naming its ROADMAP slice, from the
  pod's process before any rank starts. The tensor and expert samples
  (gpt2-tp, llama-moe) are ``tests/test_torch_dist_emitted_tp.py``'s,
  the seq samples (gpt2-longctx, llama-ulysses)
  ``tests/test_torch_seq_emitted.py``'s, on this file's helpers.
- ``M2KT_PLAN_REPORT`` writes the report from rank 0 alone, with every
  rank's measured peak.

Every subprocess runs in ``tmp_path`` with an env holding no ``M2KT_*``
key but the ones it sets, under a timeout.
"""

import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.containerizer import jax_emit  # noqa: E402
from tests.test_torch_emitted_train import (  # noqa: E402
    GPT2_TINY,
    LLAMA_TINY,
    _env,
    _hf_gpt2,
    _hf_llama,
    _port_payload,
    _run,
    _service,
    _write,
    run_jax_trainer,
    run_port_trainer,
)
from tests.test_torch_port_weights import hf_bert  # noqa: E402
from tests.test_torch_ring import (  # noqa: E402,F401
    _process_state_unchanged,
)

# the step-10 loss, printed to 4 decimals by both trainers: fp32 sums in
# other orders (two ranks' halves, the ring) and two frameworks' kernels;
# one unit of the 4th decimal (tests/test_torch_emitted_train.py)
LOSS_REL = 1e-4
# hf_bert's defaults: 2 layers, vocab 64, d 16, 2 heads, mlp 32, 24
# positions, 3 classes
BERT_TINY = {"M2KT_VOCAB": 64, "M2KT_LAYERS": 2, "M2KT_HEADS": 2,
             "M2KT_DMODEL": 16, "M2KT_MLP_DIM": 32, "M2KT_SEQ_LEN": 16,
             "M2KT_MAX_LEN": 24, "M2KT_NUM_CLASSES": 3}
RESNET_TINY = {"M2KT_IMAGE_SIZE": 32, "M2KT_NUM_CLASSES": 10}
RUNS = {"gpt2": dict(GPT2_TINY, M2KT_PRECISION="fp32"),
        "bert": BERT_TINY, "resnet": RESNET_TINY,
        "llama3-8b": dict(LLAMA_TINY, M2KT_PRECISION="fp32"),
        "gpt2-tp": dict(GPT2_TINY, M2KT_PRECISION="fp32"),
        "llama-moe": dict(LLAMA_TINY, M2KT_PRECISION="fp32",
                          M2KT_MOE_EXPERTS="4")}
BPD = 2


def _step_loss(out: str, step: int) -> float:
    return float(re.search(rf"\[m2kt\] step={step} loss=([-\d.]+)",
                           out).group(1))


def _ported(cwd, env, hf, ckpt):
    """``port_weights.py`` of the payload at ``cwd``: the HF state dict
    under ``hf`` into the trainer's step-0 checkpoint ``ckpt``."""
    env = dict(env, M2KT_CKPT_DIR=str(ckpt))
    ported = _run(cwd, [sys.executable, "port_weights.py", str(hf),
                        str(ckpt)], dict(env, M2KT_DEVICE="cpu"))
    assert ported.returncode == 0, ported.stderr[-3000:]
    return env


def _world_of_two(tmp_path, sample, world: int = 2, knobs=None,
                  batch_ranks: int = 2):
    """The port's trainer in a world of ``world`` ranks (``knobs``: more
    env) beside the JAX trainer on one device at ``batch_ranks`` times
    the per-device batch: the same global batch (per-device batch x data
    x fsdp)."""
    svc, plan = _service(sample)
    payload = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_STEPS=10, M2KT_CKPT_EVERY=100,
               **dict(RUNS[sample], M2KT_BATCH_PER_DEVICE=BPD))
    two = dict(env, M2KT_FORCE_DEVICES=str(world), M2KT_PLAN_REPORT=str(
        tmp_path / "report"), **(knobs or {}))
    one = dict(env, M2KT_BATCH_PER_DEVICE=str(batch_ranks * BPD))
    if sample == "resnet":
        return run_port_trainer(payload, two), None
    elif sample == "llama-moe":
        # no HF converter takes an MoE: both sides start from one flax
        # init, each in its own checkpoint format
        jdir = _write(jax_emit.emit_container(svc, plan).new_files,
                      tmp_path / "jax")
        two = dict(two, M2KT_CKPT_DIR=str(tmp_path / "ckpt-port"))
        one = dict(one, M2KT_CKPT_DIR=str(tmp_path / "ckpt-jax"))
        _moe_step0(tmp_path / "ckpt-jax", tmp_path / "ckpt-port")
        ref = lambda: run_jax_trainer(jdir, one)  # noqa: E731
    else:
        hf = tmp_path / "hf"
        hf.mkdir()
        if sample.startswith("gpt2"):
            _hf_gpt2(hf / "pytorch_model.bin")
        elif sample.startswith("llama"):
            _hf_llama(hf / "pytorch_model.bin")
        else:
            torch.save(hf_bert()[0], hf / "pytorch_model.bin")
        jdir = _write(jax_emit.emit_container(svc, plan).new_files,
                      tmp_path / "jax")
        two = _ported(payload, two, hf, tmp_path / "ckpt-port")
        one = _ported(jdir, one, hf, tmp_path / "ckpt-jax")
        ref = lambda: run_jax_trainer(jdir, one)  # noqa: E731
    with ThreadPoolExecutor(2) as pool:
        mine = pool.submit(run_port_trainer, payload, two)
        want = pool.submit(ref)
        return mine.result(), want.result()


def _moe_step0(jax_ckpt, port_ckpt) -> None:
    """The tiny MoE Llama's flax init (``RUNS["llama-moe"]``'s widths) as
    each trainer's step-0 params-only checkpoint."""
    import jax
    import jax.numpy as jnp

    from move2kube_tpu.models import checkpoint as jckpt
    from move2kube_tpu.models import llama as jllama
    from move2kube_tpu_torch.models import checkpoint as tckpt
    from move2kube_tpu_torch.models import llama as tllama
    from move2kube_tpu_torch.models.convert import params_from_jax

    knobs = RUNS["llama-moe"]
    widths = dict(vocab_size=int(knobs["M2KT_VOCAB"]),
                  d_model=int(knobs["M2KT_DMODEL"]),
                  num_layers=int(knobs["M2KT_LAYERS"]),
                  num_heads=int(knobs["M2KT_HEADS"]),
                  num_kv_heads=int(knobs["M2KT_KV_HEADS"]),
                  mlp_dim=int(knobs["M2KT_MLP_DIM"]),
                  moe_experts=int(knobs["M2KT_MOE_EXPERTS"]))
    model = jllama.Llama(jllama.LlamaConfig(dtype=jnp.float32, **widths))
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros(
        (2, 32), jnp.int32)))["params"]
    mngr = jckpt.CheckpointManager(str(jax_ckpt), every=1)
    mngr.maybe_save(0, {"params": jax.tree.map(jnp.asarray, params)},
                    force=True)
    mngr.close()
    mngr = tckpt.CheckpointManager(str(port_ckpt), every=1)
    mngr.maybe_save(0, {"params": params_from_jax(params, tllama.LlamaConfig(
        dtype=torch.float32, **widths))}, force=True)
    mngr.close()


@pytest.mark.parametrize("sample", ["gpt2", "bert", "resnet"])
def test_data_parallel_samples_train_in_a_world_of_two(tmp_path, sample):
    run, ref = _world_of_two(tmp_path, sample)
    assert run.returncode == 0, run.stderr[-3000:]
    plans = [x for x in run.stdout.splitlines()
             if x.startswith("[m2kt] devices=")]
    assert len(plans) == 1 and plans[0].startswith(
        "[m2kt] devices=2 mesh=2x1x1x1x1x1 ")
    assert plans[0].endswith(" layout=[] source=fallback-chain")
    assert run.stdout.count("[m2kt] done steps=10") == 1
    assert "backend=gloo" in run.stdout
    got = _step_loss(run.stdout, 10)
    if ref is None:
        assert np.isfinite(got)
    else:
        assert ref.returncode == 0, ref.stderr[-3000:]
        want = _step_loss(ref.stdout, 10)
        assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    report = json.loads((tmp_path / "report" /
                         "m2kt-plan-report.json").read_text())
    assert report["mesh"]["extents"]["data"] == 2
    assert report["predicted"]["total_bytes"] > 0
    assert sorted(p.name for p in (tmp_path / "report").iterdir()) == [
        "m2kt-plan-report.json", "m2kt-plan-report.md"]


# gpt2-tp and llama-moe train their tensor and expert axes
# (tests/test_torch_dist_emitted_tp.py), gpt2-longctx and llama-ulysses
# their seq axis (tests/test_torch_seq_emitted.py); a pipe axis is
# refused
AXES_CASES = [("gpt2-pp", "9e", {})]


@pytest.mark.parametrize("sample,slice_,knobs", AXES_CASES,
                         ids=[f"{a}-{b}" for a, b, _ in AXES_CASES])
def test_a_plan_with_a_model_axis_exits_2_naming_its_slice(tmp_path, sample,
                                                           slice_, knobs):
    svc, _ = _service(sample)
    payload = _port_payload(svc, tmp_path)
    env = _env(tmp_path, M2KT_STEPS=1, OMP_NUM_THREADS=1,
               **{**GPT2_TINY, "M2KT_FORCE_DEVICES": 2, **knobs})
    run = run_port_trainer(payload, env)
    assert run.returncode == 2, run.stderr[-3000:]
    assert f"ROADMAP Queue 1 item {slice_}" in run.stdout
    assert "[m2kt] done" not in run.stdout
