"""Tiny real trainer wired through the whole resilience stack: the port's
counterpart of ``move2kube_tpu/resilience/minitrain.py``.

The fault-injection harness needs a *runnable* training child (real
steps, real checkpoints, real resume) that finishes in seconds. This
module is that child. It mirrors the emitted trainer's loop: restore,
then step, fault and save, then the preemption check, then the goodput
flush, so what a test proves here is the control flow the trainers run.

Run under the supervisor::

    M2KT_DEVICE=cpu python -m move2kube_tpu_torch.resilience.supervisor \\
        -- python -m move2kube_tpu_torch.resilience.minitrain

It runs on the card unless ``M2KT_DEVICE=cpu``; with no card and no such
knob it raises rather than moving to the CPU. The model (8 -> 8 -> 4,
ReLU, SGD at 1e-2, loss ``mean(out**2)``) draws its weights from a numpy
seed. Each step's batch is seeded by the step number alone, so two runs
see identical data. Every step prints its loss with ``float.hex`` (its
bits), so a resumed run can be held to an uninterrupted one exactly.

Multislice on the CPU: ``M2KT_FORCE_DEVICES=N`` (with ``M2KT_DEVICE=cpu``)
starts N local gloo ranks (:func:`~move2kube_tpu_torch.parallel.mesh.
launch_local_ranks`), the port's counterpart of the reference's N forced
host devices in one process, and ``M2KT_NUM_SLICES=K`` makes the planner
lay a ``dcn_dp=K`` outer data axis over them. The ranks train data
parallel (the ring of :mod:`move2kube_tpu_torch.parallel.overlap`) and
the pod's process exits with their common code (83 on ``slice_loss``), so
the supervisor's elastic re-plan shrinks both knobs after a slice loss
and the restarted attempt re-plans for the smaller world.
``M2KT_MESH_FSDP`` (the planner's explicit extents) plans an fsdp axis:
each rank keeps its shards of the weights (``shard_params``), the step
gathers them and reduce-scatters the gradients (the schedule that
``M2KT_FSDP_PREFETCH`` picks, as in the trainers: the step is theirs,
:func:`make_step`), and the checkpoint is saved sharded.
``M2KT_MESH_TENSOR``, ``M2KT_MESH_SEQ`` and ``M2KT_MESH_EXPERT`` plan
those axes: the rules cut none of this model's leaves over them (its
kernels are not Megatron projections, and it has no token axis to cut),
so the ranks of one batch coordinate train the same rows as copies, as
the reference's GSPMD step runs it. Global batch:
``M2KT_BATCH_PER_DEVICE`` (default 4) x the planned data x fsdp extents;
each step's batch is seeded by the step alone and each rank takes its
rows, so two runs with the same global batch see the same data whatever
the world. Rank 0 prints, writes the goodput file and the span ring.

Knobs: ``M2KT_STEPS`` (default 8), ``M2KT_CKPT_DIR``/``M2KT_CKPT_EVERY``
(checkpointing off when unset, like the emitted trainers),
``M2KT_STEP_SLEEP_S`` (default 0: pad steps so goodput numbers have
visible magnitude), plus every ``M2KT_FAULT_*`` / ``M2KT_PREEMPT_*`` knob
of :mod:`.faults` and :mod:`.preemption`. Unlike the reference, this
harness runs no cost model and no straggler detector.
"""

from __future__ import annotations

import os
import sys
import time

DIM = 8


def _device():
    from move2kube_tpu_torch._device import resolve_device

    return resolve_device(os.environ.get("M2KT_DEVICE") or None)


def build_state(device):
    """The tiny model on ``device`` with weights drawn from numpy seed 0,
    in a ``TrainState`` with SGD at 1e-2."""
    import numpy as np
    import torch

    from move2kube_tpu_torch.models.train import Optimizer, TrainState

    rng = np.random.default_rng(0)
    model = torch.nn.Sequential(torch.nn.Linear(DIM, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 4))
    with torch.no_grad():
        for p in model.parameters():
            fan_in = p.shape[-1]
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape), np.float32) / np.float32(np.sqrt(fan_in))))
    model.to(device)
    opt = Optimizer(torch.optim.SGD(model.parameters(), lr=1e-2))
    return TrainState(model, opt)


def make_batch(i: int, batch: int, device):
    """Step ``i``'s batch, seeded by the step alone."""
    import numpy as np
    import torch

    return torch.from_numpy(
        np.random.default_rng(i).random((batch, DIM), np.float32)).to(device)


def _loss(model, batch):
    out = model(batch["x"])
    return (out * out).mean()


def make_step(mesh=None):
    """``step(state, x) -> (state, loss)``: one SGD step on ``x`` through
    the trainers' step (:func:`~move2kube_tpu_torch.models.train.
    make_train_step`): on a ``mesh`` of more than one rank the data ring,
    or the fsdp schedule for a model of shards, and the loss as the
    group's mean."""
    from move2kube_tpu_torch.models.train import make_train_step

    step = make_train_step(_loss, mesh=mesh)
    return lambda state, x: step(state, {"x": x})


def main() -> None:
    device = _device()

    from move2kube_tpu_torch.parallel import mesh as m2kt_mesh

    n_local = m2kt_mesh.local_device_count(device)
    if n_local > 1 and not m2kt_mesh.is_rank_process():
        sys.exit(m2kt_mesh.launch_local_ranks(
            [sys.executable, "-m", "move2kube_tpu_torch.resilience.minitrain"],
            n_local))

    from move2kube_tpu_torch.models import checkpoint as m2kt_ckpt
    from move2kube_tpu_torch.obs import tracing
    from move2kube_tpu_torch.parallel.topology import resolve_mesh_plan
    from move2kube_tpu_torch.resilience import faults, goodput, preemption

    layout = m2kt_mesh.process_layout()
    device = m2kt_mesh.rank_device(device, layout)
    layout = m2kt_mesh.initialize_distributed(device)
    lead = layout.rank == 0
    # per-step spans into the bounded ring, flushed to <flight>.ring on
    # every teardown-running exit path so the supervisor's flight
    # recorder can reconstruct the final seconds of a dead attempt
    tracer = tracing.get() if tracing.enabled() and lead else None
    if tracer is not None:
        tracing.install_ring_flush()

    steps = int(os.environ.get("M2KT_STEPS", "8"))
    step_sleep = float(os.environ.get("M2KT_STEP_SLEEP_S", "0"))
    bpd = int(os.environ.get("M2KT_BATCH_PER_DEVICE", "4") or 4)

    gp = goodput.GoodputTracker()
    watcher = preemption.from_env()
    if watcher is not None:
        watcher.install()
    # the emitted trainers' startup: plan (num_slices from
    # M2KT_NUM_SLICES, shrunk by the elastic supervisor after a slice
    # loss), then the mesh over the ranks
    plan = resolve_mesh_plan(layout.world)
    m2kt_mesh.check_ported_mesh(plan.config)
    batch = bpd * plan.config.data * plan.config.fsdp
    mesh = m2kt_mesh.make_mesh(plan, device) if layout.world > 1 else None
    if lead:
        print(f"[m2kt] device={device} plan: {plan.describe()} "
              f"devices={layout.world} global_batch={batch}", flush=True)
    state = build_state(device)
    cfg = plan.config
    if max(cfg.fsdp, cfg.tensor, cfg.expert) > 1:
        from move2kube_tpu_torch.parallel.sharding import shard_params

        # every rank drew the same weights from the seed: each keeps its
        # part of each leaf the rules cut
        shard_params(state.model, mesh)
    train_step = make_step(mesh)
    # the tensor and expert ranks of one batch coordinate take its rows
    rows_of = m2kt_mesh.batch_layout(layout, cfg)
    per = batch // rows_of.world
    rows = slice(rows_of.rank * per, (rows_of.rank + 1) * per)

    ckpt = m2kt_ckpt.from_env(default_every=1)
    start = 0
    if ckpt is not None:
        ckpt.install_exit_flush()
        with gp.phase("restore"):
            state, start = ckpt.restore_or_init(state)
        if start:
            gp.note_resume(start)
            gp.note_saved(start)
            if lead:
                print(f"[m2kt] resumed from step {start}", flush=True)

    preempted_at = None
    loss = None
    try:
        for i in range(start + 1, steps + 1):
            faults.maybe_inject(i)
            t0 = time.perf_counter()
            state, loss = train_step(state,
                                     make_batch(i, batch, device)[rows])
            if lead:
                print(f"[m2kt] step {i} loss {float(loss).hex()}",
                      flush=True)
            if step_sleep:
                time.sleep(step_sleep)
            t1 = time.perf_counter()
            if tracer is not None:
                tracer.record(
                    "train.compile" if i == start + 1 else "train.step",
                    t0, t1, attrs={"step": i})
            gp.add("compile" if i == start + 1 else "productive",
                   t1 - t0, steps=1)
            if ckpt is not None and ckpt.maybe_save(i, state):
                # synchronous commit: the fault tests assert resume-from-N,
                # so a save the loop reports must be durable before a kill
                # can land
                ckpt.wait()
                gp.note_saved(i)
                if lead:
                    gp.write()
            if watcher is not None and watcher.should_stop(i):
                preempted_at = i
                break
    except SystemExit:
        # injected fault (slice_loss exits 83, exit kind exits N): a save
        # still in flight must land before the process dies (no barrier:
        # the peers may be gone). The goodput report is deliberately NOT
        # re-flushed here: post-checkpoint work is the supervisor's
        # "lost" span.
        if ckpt is not None:
            ckpt.flush()
        raise
    finally:
        if watcher is not None:
            watcher.uninstall()
    if ckpt is not None:
        last = preempted_at if preempted_at is not None else steps
        with gp.phase("save"):
            if last >= start + 1:
                ckpt.maybe_save(last, state, force=True)
            ckpt.close()  # block: the last save must land before exit
        gp.note_saved(last)
    rep = gp.report()
    if lead:
        if loss is not None:
            print(f"[m2kt] step={gp.steps_done} loss={float(loss):.6f}",
                  flush=True)
        gp.write()
        if preempted_at is not None:
            print(f"[m2kt] preempted: last-chance checkpoint at step "
                  f"{preempted_at}; goodput={rep['goodput_fraction']:.2%}",
                  flush=True)
        else:
            print(f"[m2kt] done steps={steps} "
                  f"goodput={rep['goodput_fraction']:.2%}", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    if preempted_at is not None:
        sys.exit(143)


if __name__ == "__main__":
    main()
