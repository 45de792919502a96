"""The port's emitted trainer on the llama3-8b sample (DeepSpeed ZeRO-3,
baked fsdp=64) in a world of two ranks on the CPU (``M2KT_DEVICE=cpu
M2KT_FORCE_DEVICES=2``), at tiny widths, 10 steps, fp32: it plans fsdp=2
for two devices, as the JAX trainer's planner does, and trains it. Each
rank builds only its shards (``create_sharded_state``), restores the
ported tiny HF Llama into them (``port_weights.py``'s params-only tree,
read into shards), and saves its checkpoint sharded; its step-10 loss
matches the JAX emitted trainer on one device at twice the per-device
batch (the same global batch) within ``LOSS_REL``; the plan report
carries both ranks' peaks and the schedule's bytes beyond the plan. The harness is
``tests/test_torch_dist_emitted.py``'s; every subprocess runs in
``tmp_path`` with an env holding no ``M2KT_*`` key but the ones it sets,
under a timeout.
"""

import json

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


def test_the_zero3_sample_trains_fsdp_in_a_world_of_two(tmp_path):
    """llama3-8b's plan for two devices is fsdp=2 (the reference's
    ZeRO-3 mesh): the port's trainer shards its state, trains it to the
    JAX trainer's loss on one device and saves it sharded."""
    run, ref = _world_of_two(tmp_path, "llama3-8b")
    assert run.returncode == 0, run.stderr[-3000:]
    plans = [x for x in run.stdout.splitlines()
             if x.startswith("[m2kt] devices=")]
    assert len(plans) == 1 and plans[0].startswith(
        "[m2kt] devices=2 mesh=1x2x1x1x1x1 "), plans
    assert " layout=[] " in plans[0] + " "
    assert run.stdout.count("[m2kt] done steps=10") == 1
    assert "[m2kt] loaded ported weights from checkpoint step 0" \
        in run.stdout
    assert ref.returncode == 0, ref.stderr[-3000:]
    got, want = _step_loss(run.stdout, 10), _step_loss(ref.stdout, 10)
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
    assert sorted(p.name for p in (tmp_path / "ckpt-port" / "10")
                  .iterdir()) == ["meta.json", "shard-0.pt", "shard-1.pt",
                                  "state.pt"]
    report = json.loads((tmp_path / "report" /
                         "m2kt-plan-report.json").read_text())
    assert report["mesh"]["extents"]["fsdp"] == 2
    assert len(report["drift"]["measured_peak_hbm_bytes_by_rank"]) == 2
    # what the schedule holds beyond the plan is flagged beside it
    extra = report["fsdp_transients"]
    assert extra["schedule"] == "prefetched"
    assert extra["gathered_params_bytes"] > 0
    assert extra["total_bytes"] == (extra["gathered_params_bytes"]
                                    + extra["cast_params_bytes"]
                                    + extra["full_grads_bytes"])
    assert extra["predicted_with_transients_bytes"] == (
        report["predicted"]["total_bytes"] + extra["total_bytes"])
