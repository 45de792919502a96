"""The port's emitted trainer on the tensor- and expert-parallel samples,
at tiny widths, 10 steps, fp32, on the CPU, against the JAX emitted
trainer on one device over the same global batch (per-device batch x
data x fsdp: the tensor and expert ranks of one batch coordinate train
the same rows), within ``LOSS_REL`` of its step-10 loss:

- gpt2-tp (Megatron tensor parallelism, baked data=4 x tensor=2) plans
  tensor=2 for a world of two and trains it: each rank its heads, its
  vocab rows of the tied embedding and head;
- llama-moe (DeepSpeed-MoE with ZeRO-3, baked fsdp=2 x tensor=2 x
  expert=4) in a world of four with ``M2KT_MESH_TENSOR=2
  M2KT_MESH_EXPERT=2``: each rank its heads and its experts.

Both start from one tiny HF state dict through their side's
``port_weights.py`` and save their checkpoints sharded. The harness is
``tests/test_torch_dist_emitted.py``'s; every subprocess runs in
``tmp_path`` with an env holding no ``M2KT_*`` key but the ones it sets,
under a timeout.
"""

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from tests.test_torch_dist_emitted import (  # noqa: E402
    LOSS_REL,
    _step_loss,
    _world_of_two,
)
from tests.test_torch_ring import (  # noqa: E402,F401
    _process_state_unchanged,
)

# sample, world, env, the plan's mesh, the checkpoint's shard files
TP_CASES = [("gpt2-tp", 2, {}, "1x1x1x2x1x1", 2),
            ("llama-moe", 4, {"M2KT_MESH_TENSOR": "2",
                              "M2KT_MESH_EXPERT": "2"}, "1x1x1x2x1x2", 4)]


@pytest.mark.parametrize("sample,world,knobs,mesh,files", TP_CASES,
                         ids=[c[0] for c in TP_CASES])
def test_tensor_and_expert_samples_train_to_the_jax_loss(
        tmp_path, sample, world, knobs, mesh, files):
    run, ref = _world_of_two(tmp_path, sample, world,
                             dict(knobs, OMP_NUM_THREADS="1"), 1)
    assert run.returncode == 0, run.stderr[-3000:]
    plans = [x for x in run.stdout.splitlines()
             if x.startswith("[m2kt] devices=")]
    assert len(plans) == 1 and plans[0].startswith(
        f"[m2kt] devices={world} mesh={mesh} "), plans
    assert run.stdout.count("[m2kt] done steps=10") == 1
    assert "[m2kt] loaded ported weights from checkpoint step 0" \
        in run.stdout
    assert ref.returncode == 0, ref.stderr[-3000:]
    got, want = _step_loss(run.stdout, 10), _step_loss(ref.stdout, 10)
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    step = tmp_path / "ckpt-port" / "10"
    assert sorted(p.name for p in step.iterdir()) == sorted(
        ["meta.json", "state.pt"] + [f"shard-{r}.pt" for r in range(files)])

