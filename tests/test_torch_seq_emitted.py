"""The port's emitted trainer on the two sequence-parallel samples, at tiny
widths, 10 steps, fp32, on the CPU, against the JAX emitted trainer on
one device over the same global batch (per-device batch x data x fsdp:
the seq ranks of one batch coordinate train the same rows), within
``LOSS_REL`` of its step-10 loss, both sides starting from one tiny HF
state dict through their own ``port_weights.py``:

- gpt2-longctx (DeepSpeed sequence-parallel size 4, ZeRO-2) in a world
  of two with ``M2KT_MESH_SEQ=2``: ring attention, the baked default;
- llama-ulysses (size 4, ZeRO-3) in a world of two with
  ``M2KT_MESH_SEQ=2 M2KT_ATTN_IMPL=ulysses``, in a world of four on its
  own plan (seq=4, ring), and in a world of two on the planner's plan for
  two devices (fsdp=2: no seq axis, so the baked default ``ring`` runs
  flash, as the JAX trainer's model falls back);
- gpt2, whose baked mesh has no seq axis (so the baked default is
  ``flash``), in a world of two with ``M2KT_MESH_SEQ=2``: flash over a
  seq group runs the ring, as the reference's flash runs under GSPMD on
  the whole sequence;
- on one device both samples train and print the JAX trainer's plan
  line.

The planner's plans for these samples (``parallel/topology.py``
``resolve_mesh_plan`` on the degrees the emitter bakes) are checked
directly: seq=4 at four devices; at two, seq dropped and fsdp=2. The
harness is ``tests/test_torch_dist_emitted.py``'s; every subprocess runs
in ``tmp_path`` with an env holding no ``M2KT_*`` key but the ones it
sets, under a timeout. Each sample's JAX reference runs once, beside the
port's runs.
"""

import ast
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.containerizer import jax_emit  # noqa: E402
from tests.test_torch_dist_emitted import (  # noqa: E402
    LOSS_REL,
    _ported,
    _step_loss,
)
from tests.test_torch_emitted_train import (  # noqa: E402
    GPT2_TINY,
    LLAMA_TINY,
    _env,
    _hf_gpt2,
    _hf_llama,
    _port_payload,
    _service,
    _write,
    run_jax_trainer,
    run_port_trainer,
)
from tests.test_torch_ring import (  # noqa: E402,F401
    _process_state_unchanged,
)

SEQ_SAMPLES = ["gpt2-longctx", "llama-ulysses"]
SAMPLES = {"gpt2-longctx": (GPT2_TINY, _hf_gpt2),
           "llama-ulysses": (LLAMA_TINY, _hf_llama),
           "gpt2": (GPT2_TINY, _hf_gpt2)}
BPD = 2
# (sample, world, env, the plan's mesh, per-device batch); the global
# batch is BPD rows on every plan
CASES = [
    ("gpt2-longctx", 1, {}, "1x1x1x1x1x1", BPD),
    ("gpt2-longctx", 2, {"M2KT_MESH_SEQ": "2"}, "1x1x1x1x2x1", BPD),
    ("llama-ulysses", 1, {}, "1x1x1x1x1x1", BPD),
    ("llama-ulysses", 2, {"M2KT_MESH_SEQ": "2",
                          "M2KT_ATTN_IMPL": "ulysses"}, "1x1x1x1x2x1", BPD),
    ("llama-ulysses", 4, {}, "1x1x1x1x4x1", BPD),
    ("llama-ulysses", 2, {}, "1x2x1x1x1x1", BPD // 2),
    ("gpt2", 2, {"M2KT_MESH_SEQ": "2"}, "1x1x1x1x2x1", BPD),
]


def _id(case) -> str:
    sample, world, knobs, mesh, _ = case
    return f"{sample}-world{world}-" + mesh.replace("x", "")


def _plan_line(out: str) -> list:
    return [x for x in out.splitlines() if x.startswith("[m2kt] devices=")]


@pytest.fixture(scope="module")
def seq_trainers(tmp_path_factory):
    """Each sample's JAX trainer on one device and every case's port
    trainer, all started at once."""
    tmp = tmp_path_factory.mktemp("seqemit")
    jobs = {}
    with ThreadPoolExecutor(len(CASES) + len(SAMPLES)) as pool:
        for sample, (tiny, make_hf) in SAMPLES.items():
            svc, plan = _service(sample)
            base = tmp / sample
            hf = base / "hf"
            hf.mkdir(parents=True)
            make_hf(hf / "pytorch_model.bin")
            env = _env(base, M2KT_STEPS=10, M2KT_CKPT_EVERY=100,
                       **dict(tiny, M2KT_PRECISION="fp32",
                              M2KT_BATCH_PER_DEVICE=BPD))
            jdir = _write(jax_emit.emit_container(svc, plan).new_files,
                          base / "jax")
            one = _ported(jdir, env, hf, base / "ckpt-jax")
            jobs[sample] = pool.submit(run_jax_trainer, jdir, one)
            for i, case in enumerate(CASES):
                if case[0] != sample:
                    continue
                _, world, knobs, _, bpd = case
                payload = _port_payload(svc, base, f"port{i}")
                run_env = dict(env, M2KT_BATCH_PER_DEVICE=str(bpd), **knobs)
                if world > 1:
                    run_env["M2KT_FORCE_DEVICES"] = str(world)
                run_env = _ported(payload, run_env, hf, base / f"ckpt{i}")
                jobs[i] = pool.submit(run_port_trainer, payload, run_env)
        return {key: job.result() for key, job in jobs.items()}


@pytest.mark.parametrize("i", range(len(CASES)), ids=[_id(c) for c in CASES])
def test_seq_samples_train_to_the_jax_loss(seq_trainers, i):
    sample, world, _, mesh, _ = CASES[i]
    run, ref = seq_trainers[i], seq_trainers[sample]
    assert run.returncode == 0, run.stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    plans = _plan_line(run.stdout)
    assert len(plans) == 1 and plans[0].startswith(
        f"[m2kt] devices={world} mesh={mesh} "), plans
    if world == 1:
        # the JAX trainer's plan line on one device
        assert plans == _plan_line(ref.stdout)
    assert run.stdout.count("[m2kt] done steps=10") == 1
    assert "[m2kt] loaded ported weights from checkpoint step 0" \
        in run.stdout
    got, want = _step_loss(run.stdout, 10), _step_loss(ref.stdout, 10)
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)


def _baked(sample) -> dict:
    """The constants the port's emitter bakes into the sample's
    ``train_gpu.py``."""
    from move2kube_tpu_torch.containerizer import cuda_emit

    svc, _ = _service(sample)
    tree = ast.parse(cuda_emit.emit_container(svc).new_files["train_gpu.py"])
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) in ("DEGREES",
                                                         "TOPOLOGY", "MESH")}


@pytest.mark.parametrize("sample", SEQ_SAMPLES)
def test_the_planner_plans_seq_at_four_devices_and_fsdp_at_two(sample):
    from move2kube_tpu_torch.parallel.topology import resolve_mesh_plan

    baked = _baked(sample)
    assert baked["MESH"]["seq"] > 1 and baked["DEGREES"]["seq_parallel"] == 4
    four, two = (resolve_mesh_plan(n, default_topology=baked["TOPOLOGY"],
                                   num_slices=1, env={},
                                   **baked["DEGREES"]).config
                 for n in (4, 2))
    assert (four.seq, four.data * four.fsdp) == (4, 1), four
    assert (two.seq, two.fsdp, two.data) == (1, 2, 1), two
