#!/usr/bin/env python
"""Data-parallel GPU training program generated by move2kube-tpu (cuda
emitter).

The workload this program replaces, what was detected in it and the mesh
its parallelism maps onto are baked into the constants below
(``SOURCE_ENTRYPOINT``, ``FRAMEWORKS``, ``BACKEND``, ``GPU_COUNT``,
``FAMILY``, ``MESH``, ``DEGREES``, ``TOPOLOGY``).

How a pod runs: this process is the pod's one process (under
``resilience/supervisor.py``, as the JAX trainer); it starts one rank a
visible card (or a rank a forced CPU device under ``M2KT_DEVICE=cpu
M2KT_FORCE_DEVICES=N``) and exits with their code. World and rank come
from the JobSet's env: hosts = ``M2KT_NUM_HOSTS`` x ``M2KT_NUM_SLICES``,
the host index ``M2KT_SLICE_ID`` x hosts + ``JOB_COMPLETION_INDEX``,
the rendezvous ``M2KT_COORDINATOR`` (``torchrun``'s ``WORLD_SIZE``/
``RANK``/``LOCAL_RANK``/``MASTER_ADDR`` win when set); a world of more
than one pod with no rendezvous exits 2 at once. Every rank joins the
process group (NCCL on cards, gloo on the CPU; a world of one too), then
plans its mesh from the world as the JAX trainer plans it from its
devices (``resolve_mesh_plan`` with the baked topology, degrees and
slice count; an explicit ``M2KT_MESH_*`` whose product is the world
wins) and prints the JAX trainer's plan line, with ``layout=[]``. The
global batch is ``BATCH_PER_DEVICE`` x data x fsdp and each rank trains
its rows of it; gradients are ring-reduced (``parallel/overlap.py``). On
a plan with an fsdp axis (the llama3-8b sample's ZeRO-3 mesh) each rank
builds only its shards of the parameters (``create_sharded_state``), the
optimizer's moments are shards too, the step gathers the parameters and
reduce-scatters the gradients, and the checkpoint is saved sharded. On
a plan with a tensor or expert axis (the gpt2-tp sample's Megatron
split, the llama-moe sample's experts) each rank builds its parts over
every axis the same way and the Llama, GPT-2 and MoE forwards split
their heads, vocab rows and experts; the tensor and expert ranks of one
batch coordinate train the same rows. On a plan with a seq axis (the
gpt2-longctx and llama-ulysses samples' sequence parallelism) the seq
ranks of a batch coordinate hold the same rows, each runs its shard of
their tokens, and attention is ring (the baked default where the baked
mesh has a seq axis) or Ulysses (``M2KT_ATTN_IMPL=ulysses``) over them;
off a seq axis both run flash, as the JAX trainer's model falls back;
``flash`` on a seq axis (``M2KT_MESH_SEQ`` on a sample baked without
one) runs the ring. A
plan with a pipe axis above 1 exits 2 naming the ROADMAP slice (Queue 1
item 9e) that brings it. A pipelined workload planned on one device trains its
plain model, as the JAX trainer falls back to it. Rank 0 prints the step
lines; each pod's first rank serves the telemetry and writes the
goodput, usage and flight files.

The model comes from the vendored ``move2kube_tpu_torch`` package
alongside this file; attention runs in its hand-written CUDA kernels.
Swap ``make_batch`` for your real input pipeline (or point ``M2KT_DATA``
at npy/npz/jsonl); the synthetic generator keeps shapes and dtypes
identical, so the program trains end to end out of the box. It runs on
the card unless ``M2KT_DEVICE=cpu``; with no card and no such knob it
exits non-zero rather than moving to the CPU.

``M2KT_PLAN_REPORT`` writes ``m2kt-plan-report.json`` and ``.md``: the
memory plan (``parallel/memory.py``) on the card's budget beside the
first step's counted cost and measured peak (in a world above one, every
rank's peak beside the plan's per-device bytes). Knobs the JAX trainer reads
that this one does not: ``M2KT_FUSED_CE`` (the loss folds the head into
the chunked cross-entropy whenever the vocab spans more than one chunk,
with no ladder); ``M2KT_VERIFY_DONATION`` (eager PyTorch donates nothing;
``1`` prints one line saying so). Besides the JAX program's lines it
prints ``[m2kt] kernel launches {...}`` (rank 0's) before ``[m2kt]
done``: each attention kernel's launches in this run.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from move2kube_tpu_torch import obs as m2kt_obs
from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models import checkpoint as m2kt_ckpt
from move2kube_tpu_torch.models import convert as m2kt_convert
from move2kube_tpu_torch.models import data as m2kt_data
from move2kube_tpu_torch.models import precision as m2kt_precision
from move2kube_tpu_torch.models import train as m2kt_train
from move2kube_tpu_torch.models.compile_cache import setup_compilation_cache
from move2kube_tpu_torch.ops.attention import KERNELS, reset_launch_counts
from move2kube_tpu_torch.parallel import mesh as m2kt_mesh
from move2kube_tpu_torch.parallel.topology import resolve_mesh_plan
from move2kube_tpu_torch.resilience import faults as m2kt_faults
from move2kube_tpu_torch.resilience import goodput as m2kt_goodput
from move2kube_tpu_torch.resilience import preemption as m2kt_preempt

# m2kt:baked-begin (the emitter rewrites these lines)
SOURCE_ENTRYPOINT = "(unknown)"
FRAMEWORKS = "unknown"
BACKEND = ""
GPU_COUNT = 1
FAMILY = "llama"
MESH = {"data": 1, "fsdp": 1, "pipe": 1, "tensor": 1, "seq": 1, "expert": 1}
DEGREES = {"zero_stage": 0, "tensor_parallel": 1, "seq_parallel": 1,
           "pipeline_parallel": 1, "expert_parallel": 1}
TOPOLOGY = "1x1"
NUM_SLICES_DEFAULT = 1
PRECISION_DEFAULT = "bf16"
GRAD_ACCUM_DEFAULT = 1
MOE_EXPERTS = 0
NUMERICS = "1"
COMPILE_CACHE_DIR = "/app/.m2kt-cache"
METRICS_PORT_DEFAULT = 9090
STEPS_DEFAULT = 100
LR_DEFAULT = 0.0003
# m2kt:baked-end

LM_FAMILIES = ("llama", "gpt", "gpt2")
BATCH_DEFAULTS = {"resnet": 64, "bert": 16, "gpt2": 8, "llama": 1, "gpt": 1,
                  "unet": 16}
BATCH_PER_DEVICE = int(os.environ.get(
    "M2KT_BATCH_PER_DEVICE", str(BATCH_DEFAULTS.get(FAMILY, 32))))
if FAMILY == "resnet":
    IMAGE_SIZE = int(os.environ.get("M2KT_IMAGE_SIZE", "224"))
    NUM_CLASSES = int(os.environ.get("M2KT_NUM_CLASSES", "1000"))
elif FAMILY == "bert":
    SEQ_LEN = int(os.environ.get("M2KT_SEQ_LEN", "128"))
    NUM_CLASSES = int(os.environ.get("M2KT_NUM_CLASSES", "2"))
elif FAMILY == "gpt2":
    SEQ_LEN = int(os.environ.get("M2KT_SEQ_LEN", "1024"))
elif FAMILY in ("llama", "gpt"):
    SEQ_LEN = int(os.environ.get("M2KT_SEQ_LEN", "2048"))
elif FAMILY == "unet":
    IMAGE_SIZE = int(os.environ.get("M2KT_IMAGE_SIZE", "32"))
    DIFFUSION_STEPS = int(os.environ.get("M2KT_DIFFUSION_STEPS", "1000"))
else:
    FEATURE_DIM = int(os.environ.get("M2KT_FEATURE_DIM", "256"))
    NUM_CLASSES = int(os.environ.get("M2KT_NUM_CLASSES", "10"))

try:
    NUM_SLICES = max(1, int(os.environ.get("M2KT_NUM_SLICES", "")
                            or NUM_SLICES_DEFAULT))
except ValueError:
    NUM_SLICES = NUM_SLICES_DEFAULT
STEPS = int(os.environ.get("M2KT_STEPS", str(STEPS_DEFAULT)))
LEARNING_RATE = float(os.environ.get("M2KT_LR", str(LR_DEFAULT)))
# mixed-precision policy: bf16 compute + fp32 master weights by default
# on transformer families; M2KT_PRECISION overrides (bf16 / fp32 /
# bf16-scaled), M2KT_LOSS_SCALE tunes the static loss scale
PRECISION = m2kt_precision.from_env(default=PRECISION_DEFAULT)
# k>1 folds k microbatches into ONE optimizer update
GRAD_ACCUM = max(1, int(os.environ.get("M2KT_GRAD_ACCUM",
                                       str(GRAD_ACCUM_DEFAULT))))
# telemetry plane: /metrics, /healthz, /profile. The env wins over the
# baked-in default; 0 disables.
METRICS_PORT = int(os.environ.get("M2KT_METRICS_PORT",
                                  str(METRICS_PORT_DEFAULT)))
# numerics plane (obs/numerics.py): read when the optimizer is
# instrumented below, so it must resolve before that
os.environ.setdefault("M2KT_NUMERICS", NUMERICS)


def refuse(msg: str) -> None:
    print(f"[m2kt] {msg}", flush=True)
    raise SystemExit(2)


class GenericModel(torch.nn.Module):
    """Scaffold for an unrecognised workload — replace with your model."""

    def __init__(self, device):
        super().__init__()
        from move2kube_tpu_torch.models.layers import Dense

        self.l1 = Dense(FEATURE_DIM, 512, torch.bfloat16)
        self.l2 = Dense(512, 512, torch.bfloat16)
        self.head = Dense(512, NUM_CLASSES, torch.float32)
        self.to(device)

    def forward(self, x):
        x = torch.relu(self.l1(x))
        x = torch.relu(self.l2(x))
        return self.head(x).float()


def write_plan_report(plan, model_cfg, batch_per_chip: int, n_devices: int,
                      cost, out_dir: str, rank_peaks=None,
                      transients=None) -> None:
    """``M2KT_PLAN_REPORT``: the memory plan of the baked model on the
    plan's extents (built on the meta device) against the card's budget,
    beside the first step's counted cost and measured peak, and each
    rank's measured peak (``rank_peaks``) when the world has several. On
    an fsdp plan, ``transients`` (``overlap.fsdp_transient_bytes``): what
    the schedule holds beyond the plan (the gathered tree, its cast copy,
    the full gradients), flagged beside the plan's total."""
    from move2kube_tpu_torch.models.convert import meta_model
    from move2kube_tpu_torch.parallel.memory import train_memory_plan

    if model_cfg is None:
        print("[m2kt] plan report failed: no memory plan for the generic "
              "scaffold", flush=True)
        return
    extents = dict(zip(m2kt_mesh.MeshConfig.AXES, plan.config.dims()))
    lm = {}
    if FAMILY in LM_FAMILIES:
        # a seq rank's activations are its shard's tokens
        lm = dict(seq_len=SEQ_LEN // plan.config.seq,
                  d_model=model_cfg.d_model,
                  num_layers=model_cfg.num_layers,
                  vocab_size=model_cfg.vocab_size)
    mem = train_memory_plan(meta_model(model_cfg), extents,
                            batch_per_chip=max(1, batch_per_chip), **lm)
    accelerator = (torch.cuda.get_device_name()
                   if torch.cuda.is_available() else "")
    report = m2kt_obs.build_plan_report(mem, accelerator, mesh_plan=plan,
                                        n_devices=n_devices, cost=cost)
    if transients is not None:
        report["fsdp_transients"] = dict(
            transients,
            predicted_with_transients_bytes=mem.total
            + transients["total_bytes"])
    drift = report.get("drift", {})
    if rank_peaks is not None:
        drift["measured_peak_hbm_bytes_by_rank"] = rank_peaks
        drift["predicted_over_measured_by_rank"] = [
            round(mem.total / peak, 3) if peak else None
            for peak in rank_peaks]
    m2kt_obs.write_plan_report(report, out_dir)
    print(f"[m2kt] plan report: verdict={report['verdict']} "
          f"predicted={mem.total} "
          f"measured={drift.get('measured_peak_hbm_bytes')} "
          f"drift={drift.get('predicted_over_measured')} "
          + (f"by_rank={rank_peaks} " if rank_peaks is not None else "")
          + (f"fsdp_transients={transients['total_bytes']} "
             if transients is not None else "")
          + f"dir={out_dir}", flush=True)


def build(device, global_batch: int, mesh):
    """(state, step_fn, make_batch, accum, unit, model_cfg) for the baked
    family; ``make_batch(i)`` makes step i's global batch (the loader
    keeps this rank's rows) and the steps reduce across ``mesh``."""
    attn_default = "ring" if MESH["seq"] > 1 else "flash"
    model_cfg = None
    state = None
    # an fsdp, tensor or expert plan: each rank builds only its parts
    # (ZeRO-3, Megatron)
    mesh_cfg = m2kt_mesh.mesh_config_of(mesh) if mesh is not None else None
    sharded = mesh_cfg is not None and max(
        mesh_cfg.fsdp, mesh_cfg.tensor, mesh_cfg.expert) > 1

    def on_device(batch):
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    if FAMILY == "resnet":
        from move2kube_tpu_torch.models.resnet import resnet50

        model = m2kt_convert.init_family(
            resnet50(num_classes=NUM_CLASSES), seed=0, device=device)
        # instrument_optimizer is unconditional (not gated on
        # METRICS_PORT): checkpoints must restore whether or not
        # telemetry is on
        opt = m2kt_train.instrument_optimizer(m2kt_train.Optimizer(
            torch.optim.SGD(model.parameters(), lr=LEARNING_RATE,
                            momentum=0.9)))
        accum = GRAD_ACCUM
        step_fn = m2kt_train.make_classifier_train_step(
            has_batch_stats=True, grad_accum=accum, mesh=mesh)
        model_cfg = model.cfg

        def make_batch(i):
            gen = np.random.default_rng(i)
            return on_device({
                "input": gen.random((global_batch, IMAGE_SIZE, IMAGE_SIZE, 3),
                                    np.float32),
                "label": gen.integers(0, NUM_CLASSES, global_batch)})

        unit = "img/s"
    elif FAMILY == "bert":
        from move2kube_tpu_torch.models.bert import BertConfig

        # max_len is the positional-table size and must match ported HF
        # checkpoints (bert-base: 512)
        max_len = int(os.environ.get("M2KT_MAX_LEN", "512"))
        if SEQ_LEN > max_len:
            raise SystemExit(
                f"[m2kt] M2KT_SEQ_LEN={SEQ_LEN} exceeds the BERT positional "
                f"table (M2KT_MAX_LEN={max_len}); raise M2KT_MAX_LEN only for "
                f"from-scratch training, not ported checkpoints")
        cfg = BertConfig(
            vocab_size=int(os.environ.get("M2KT_VOCAB", "30522")),
            num_layers=int(os.environ.get("M2KT_LAYERS", "12")),
            num_heads=int(os.environ.get("M2KT_HEADS", "12")),
            d_model=int(os.environ.get("M2KT_DMODEL", "768")),
            mlp_dim=int(os.environ.get("M2KT_MLP_DIM", "3072")),
            max_len=max_len, num_classes=NUM_CLASSES)
        def bert_opt(params):
            return m2kt_train.instrument_optimizer(m2kt_train.adamw(
                params, LEARNING_RATE, weight_decay=0.01))

        if sharded:
            state = m2kt_train.create_sharded_state(cfg, mesh, bert_opt,
                                                    seed=0, device=device)
        else:
            model = m2kt_convert.init_family(cfg, seed=0, device=device)
            opt = bert_opt(model.parameters())
        step_fn = m2kt_train.make_bert_train_step(mesh=mesh)
        accum = 1  # fine-tune step has no accumulation path
        model_cfg = cfg

        def make_batch(i):
            gen = np.random.default_rng(i)
            return on_device({
                "input_ids": gen.integers(0, cfg.vocab_size,
                                          (global_batch, SEQ_LEN)),
                "attention_mask": np.ones((global_batch, SEQ_LEN), bool),
                "label": gen.integers(0, NUM_CLASSES, global_batch)})

        unit = "samples/s"
    elif FAMILY in LM_FAMILIES:
        attn = os.environ.get("M2KT_ATTN_IMPL", attn_default)
        if FAMILY == "gpt2":
            from move2kube_tpu_torch.models.gpt2 import GPT2Config

            # n_positions is the wpe table size and must match the ported
            # checkpoint (1024 for every stock GPT-2)
            n_positions = int(os.environ.get("M2KT_MAX_LEN", "1024"))
            if SEQ_LEN > n_positions:
                raise SystemExit(
                    f"M2KT_SEQ_LEN={SEQ_LEN} exceeds the GPT-2 positional "
                    f"table (M2KT_MAX_LEN={n_positions}); raise M2KT_MAX_LEN "
                    "only for checkpoints that actually have a longer wpe "
                    "table")
            cfg = GPT2Config(
                vocab_size=int(os.environ.get("M2KT_VOCAB", "50257")),
                n_positions=n_positions,
                d_model=int(os.environ.get("M2KT_DMODEL", "768")),
                num_layers=int(os.environ.get("M2KT_LAYERS", "12")),
                num_heads=int(os.environ.get("M2KT_HEADS", "12")),
                attn_impl=attn)
            init, weight_decay = m2kt_convert.init_gpt2, 0.01
        else:
            from move2kube_tpu_torch.models.llama import LlamaConfig

            cfg = LlamaConfig(
                vocab_size=int(os.environ.get("M2KT_VOCAB", "32000")),
                d_model=int(os.environ.get("M2KT_DMODEL", "4096")),
                num_layers=int(os.environ.get("M2KT_LAYERS", "32")),
                num_heads=int(os.environ.get("M2KT_HEADS", "32")),
                num_kv_heads=int(os.environ.get("M2KT_KV_HEADS", "8")),
                mlp_dim=int(os.environ.get("M2KT_MLP_DIM", "14336")),
                max_len=SEQ_LEN,
                moe_experts=int(os.environ.get("M2KT_MOE_EXPERTS",
                                               str(MOE_EXPERTS))),
                attn_impl=attn)
            init, weight_decay = m2kt_convert.init_llama, 0.1
        cfg = PRECISION.apply_to_model_config(cfg)

        def lm_opt(params):
            return m2kt_train.instrument_optimizer(PRECISION.wrap_optimizer(
                m2kt_train.adamw(params, LEARNING_RATE,
                                 weight_decay=weight_decay)))

        # fp32 master weights; the step casts them to the policy's
        # compute dtype inside the loss
        if sharded:
            state = m2kt_train.create_sharded_state(
                cfg, mesh, lm_opt, seed=0, device=device,
                dtype=torch.float32)
        else:
            model = init(cfg, seed=0, device=device, dtype=torch.float32)
            opt = lm_opt(model.parameters())
        accum = GRAD_ACCUM
        if MESH["pipe"] > 1:
            # the JAX trainer's pipeline path, which on one device trains
            # the plain model: the schedule's microbatching stands in for
            # accumulation there, so none is taken
            accum = 1
            if GRAD_ACCUM > 1:
                print("[m2kt] M2KT_GRAD_ACCUM ignored on the pipeline path: "
                      "the schedule's own microbatching is the "
                      "accumulation", flush=True)
        step_fn = m2kt_train.make_lm_train_step(grad_accum=accum,
                                                precision=PRECISION,
                                                mesh=mesh)
        model_cfg = cfg

        def make_batch(i):
            gen = np.random.default_rng(i)
            return on_device({"input_ids": gen.integers(
                0, cfg.vocab_size, (global_batch, SEQ_LEN))})

        unit = "tokens/s"
    elif FAMILY == "unet":
        from move2kube_tpu_torch.models.unet import UNetConfig

        # DDPM noise-prediction training: batches carry clean images,
        # pre-drawn noise and timesteps; the step forms x_t on the device
        cfg = UNetConfig(
            in_channels=int(os.environ.get("M2KT_CHANNELS", "3")),
            base_channels=int(os.environ.get("M2KT_BASE_CHANNELS", "128")),
            channel_mults=tuple(int(m) for m in os.environ.get(
                "M2KT_CHANNEL_MULTS", "1,2,2").split(",")),
            num_res_blocks=int(os.environ.get("M2KT_RES_BLOCKS", "2")),
            norm_groups=int(os.environ.get("M2KT_NORM_GROUPS", "32")))
        model = m2kt_convert.init_family(cfg, seed=0, device=device)
        opt = m2kt_train.instrument_optimizer(
            m2kt_train.adamw(model.parameters(), LEARNING_RATE))
        step_fn = m2kt_train.make_diffusion_train_step(
            num_diffusion_steps=DIFFUSION_STEPS, mesh=mesh)
        accum = 1  # diffusion step has no accumulation path
        model_cfg = cfg

        def make_batch(i):
            gen = np.random.default_rng(i)
            shape = (global_batch, IMAGE_SIZE, IMAGE_SIZE, cfg.in_channels)
            batch = on_device({
                "image": gen.random(shape, np.float32) * 2.0 - 1.0,
                "noise": gen.standard_normal(shape, np.float32),
                "t": gen.integers(0, DIFFUSION_STEPS, global_batch)
                .astype(np.int32)})
            batch["image"] = batch["image"].to(torch.bfloat16)
            return batch

        unit = "img/s"
    else:
        model = GenericModel(device)
        with torch.no_grad():
            m2kt_convert._init_linear_like(model, torch.Generator(
                device=device).manual_seed(0))
        opt = m2kt_train.instrument_optimizer(
            m2kt_train.adam(model.parameters(), LEARNING_RATE))
        accum = 1

        def step_fn(state, batch):
            state.optimizer.zero_grad()
            loss = m2kt_train.cross_entropy_loss(
                state.model(batch["input"]), batch["label"])
            loss.backward()
            state.optimizer.step()
            state.step += 1
            return state, loss.detach()

        def make_batch(i):
            gen = np.random.default_rng(i)
            return on_device({
                "input": gen.random((global_batch, FEATURE_DIM), np.float32),
                "label": gen.integers(0, NUM_CLASSES, global_batch)})

        unit = "samples/s"
    if state is None:
        state = m2kt_train.TrainState(model, opt)
    return state, step_fn, make_batch, accum, unit, model_cfg


def main():
    device = resolve_device(os.environ.get("M2KT_DEVICE") or None)
    try:
        n_local = m2kt_mesh.local_device_count(device)
        layout = m2kt_mesh.process_layout(
            dict(os.environ, M2KT_LOCAL_WORLD=str(n_local)))
        if layout.hosts > 1:
            # one pod's ranks meet on a local port the launcher picks
            m2kt_mesh.check_rendezvous(layout)
    except ValueError as e:
        refuse(str(e))
    if n_local > 1 and not m2kt_mesh.is_rank_process():
        # the pod's process: a plan with an axis the port does not run is
        # refused here, before any rank starts; then one rank a card (or
        # forced CPU device)
        try:
            m2kt_mesh.check_ported_mesh(resolve_mesh_plan(
                layout.world, default_topology=TOPOLOGY,
                num_slices=NUM_SLICES, **DEGREES).config)
        except NotImplementedError as e:
            refuse(str(e))
        return m2kt_mesh.launch_local_ranks(
            [sys.executable, os.path.abspath(__file__)] + sys.argv[1:],
            n_local)
    device = m2kt_mesh.rank_device(device, m2kt_mesh.process_layout())
    layout = m2kt_mesh.initialize_distributed(device)
    lead = layout.rank == 0          # prints, as the JAX process 0
    pod_lead = layout.local_rank == 0  # the pod's files and server
    # persistent kernel build cache: a restarted pod loads the previous
    # run's kernels instead of running nvcc. M2KT_COMPILE_CACHE_DIR
    # overrides (a mounted volume); M2KT_COMPILE_CACHE=0 disables.
    setup_compilation_cache(COMPILE_CACHE_DIR)
    # resilience: goodput/badput ledger + preemption watcher
    gp = m2kt_goodput.GoodputTracker()
    telem_srv = None
    if METRICS_PORT > 0 and pod_lead:
        telem_srv = m2kt_obs.start_telemetry_server(METRICS_PORT)
    m2kt_obs.install_goodput_hook(gp)
    m2kt_obs.install_trace_hook()
    # runtime tracing (M2KT_TRACE, default on): spans into a bounded
    # ring, parked at M2KT_FLIGHT_PATH+".ring" on teardown for the
    # supervisor's flight recorder
    if m2kt_obs.tracing_enabled() and pod_lead:
        m2kt_obs.install_ring_flush()
    # usage ledger (M2KT_USAGE, default on): served at GET /usage and
    # exit-flushed to m2kt-usage.jsonl
    usage_ledger = None
    if m2kt_obs.usage_enabled() and pod_lead:
        usage_ledger = m2kt_obs.UsageLedger(
            registry=m2kt_obs.default_registry())

        def _train_usage():
            rep = gp.report()
            return {"counters": {
                "steps_done": rep.get("steps_done", 0),
                "goodput_fraction": rep.get("goodput_fraction") or 0.0}}

        usage_ledger.add_source(_train_usage, "train")
        usage_ledger.start()
        m2kt_obs.install_usage_flush(usage_ledger)
        if telem_srv is not None:
            telem_srv.set_ledger(usage_ledger)
    # anomaly watchdog (M2KT_DIAG, default on): StepTelemetry feeds it
    diag_watchdog = None
    if m2kt_obs.diag_enabled():
        diag_watchdog = m2kt_obs.DiagWatchdog(
            tracer=(m2kt_obs.get_tracer()
                    if m2kt_obs.tracing_enabled() else None),
            ledger=usage_ledger)
    watcher = m2kt_preempt.from_env()
    if watcher is not None:
        watcher.install()
    # the JAX trainer's planner over the world (identity device order,
    # so layout=[]); explicit M2KT_MESH_* whose product is the world wins
    plan = resolve_mesh_plan(
        layout.world, default_topology=TOPOLOGY, num_slices=NUM_SLICES,
        **DEGREES)
    mesh_cfg = plan.config
    try:
        m2kt_mesh.check_ported_mesh(mesh_cfg)
    except NotImplementedError as e:
        refuse(str(e))
    mesh = m2kt_mesh.make_mesh(plan, device)
    if lead:
        print(f"[m2kt] devices={layout.world} {plan.describe()}", flush=True)
        print(f"[m2kt] device={device} backend={torch.distributed.get_backend()}"
              + (f" telemetry=:{telem_srv.port}" if telem_srv else ""),
              flush=True)

    global_batch = BATCH_PER_DEVICE * mesh_cfg.data * mesh_cfg.fsdp
    state, step_fn, make_batch, accum, unit, model_cfg = build(
        device, global_batch, mesh)
    lm = FAMILY in LM_FAMILIES
    items_per_step = global_batch * accum * (SEQ_LEN if lm else 1)
    telem = m2kt_train.StepTelemetry(
        items_per_step=items_per_step, unit=unit.split("/")[0])
    telem.watchdog = diag_watchdog
    telem.record_precision(PRECISION)

    # real data when M2KT_DATA points at npy/npz/jsonl; synthetic
    # batches otherwise
    loader = m2kt_data.make_loader(
        os.environ.get("M2KT_DATA", ""), global_batch, device=device,
        synthetic_fn=make_batch, mesh=mesh)
    if accum > 1:
        # the accumulating steps consume [k, ...] stacked microbatches;
        # one next() == one optimizer update
        loader = m2kt_data.AccumLoader(loader, accum)

    # resume from the latest checkpoint when M2KT_CKPT_DIR is set (a
    # params-only tree from port_weights.py starts at step 0)
    ckpt_mngr = m2kt_ckpt.from_env()
    start_step = 0
    if ckpt_mngr is not None:
        # any exit that runs interpreter teardown flushes the save in
        # flight first
        ckpt_mngr.install_exit_flush()
        with gp.phase("restore"):
            state, start_step = ckpt_mngr.restore_or_init(state)
        if start_step:
            gp.note_resume(start_step)
            gp.note_saved(start_step)
            if lead:
                print(f"[m2kt] resumed from step {start_step}", flush=True)
        elif ckpt_mngr.restored is not None and lead:
            print(f"[m2kt] loaded ported weights from checkpoint step "
                  f"{ckpt_mngr.restored['step']}", flush=True)
    # fast-forward the data stream: a resumed run continues from batch
    # start_step instead of re-consuming the first batches
    if start_step:
        loader.skip(start_step)

    if os.environ.get("M2KT_VERIFY_DONATION", "0") == "1" and lead:
        print("[m2kt] M2KT_VERIFY_DONATION: nothing to verify; the eager "
              "step updates the state in place and donates no buffer",
              flush=True)

    # the first step is counted (an uncounted warmup would apply one
    # extra update per preemption); it builds or loads the kernels, so
    # it goes to the compile ledger and timing starts after it
    first = start_step + 1
    loss = None
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    # the kernel launches line counts this run's steps and the cost
    # model's held one
    reset_launch_counts()
    # only the pod's first rank writes the goodput file
    write_goodput = gp.write if pod_lead else (lambda: None)
    if first <= STEPS:
        m2kt_faults.maybe_inject(first)
        t_compile = time.perf_counter()
        batch0 = next(loader)  # kept: the cost model runs with its shapes
        state, loss = step_fn(state, batch0)
        sync()
        dt_compile = time.perf_counter() - t_compile
        gp.add("compile", dt_compile, steps=1)
        telem.record_compile(dt_compile)
        # cost model (obs/costmodel.py): FLOPs, roofline class and peak
        # memory of one step (run with the optimizer held); record_step
        # keeps m2kt_train_mfu live from then on. Also arms the
        # <flight>.mem OOM sidecar.
        telem.record_cost_model(step_fn, state, batch0)
        if pod_lead:
            m2kt_obs.install_memory_snapshot()
        plan_dir = m2kt_obs.costmodel.plan_report_dir()
        rank_peaks = None
        if plan_dir is not None and layout.world > 1:
            # every rank's peak, gathered through the ring (a collective:
            # every rank takes part)
            from move2kube_tpu_torch.parallel import overlap

            report = telem._cost_report
            peak = (report.peak_hbm_bytes or 0) if report is not None else 0
            rank_peaks = [int(x) for x in overlap.ring_all_gather(
                torch.tensor([float(peak)], dtype=torch.float64,
                             device=device), None, 0).tolist()]
        if plan_dir is not None and lead:
            from move2kube_tpu_torch.parallel import overlap
            from move2kube_tpu_torch.parallel.sharding import layout_of

            shards = layout_of(state.model)
            transients = None if shards is None else \
                overlap.fsdp_transient_bytes(
                    shards, overlap.fsdp_prefetched(mesh), accum,
                    PRECISION.compute_dtype)
            # rows over the ranks but seq's, tokens over seq (seq_len)
            write_plan_report(plan, model_cfg,
                              global_batch * mesh_cfg.seq // layout.world,
                              layout.world, telem._cost_report, plan_dir,
                              rank_peaks, transients)
        if ckpt_mngr is not None and ckpt_mngr.maybe_save(first, state,
                                                          loader=loader):
            gp.note_saved(first)
            write_goodput()
    t0 = time.perf_counter()
    mark = t0
    acct = first  # last step whose wall time is already in the ledger
    preempted_at = None
    for i in range(first + 1, STEPS + 1):
        m2kt_faults.maybe_inject(i)
        at_sync = i % 10 == 0
        t_step = time.perf_counter()
        state, loss = step_fn(state, next(loader))
        if at_sync:
            sync()
        # unsynced steps record launch time; syncs record true wall time
        # and are the only points that read loss/grad-norm back
        telem.record_step(i, time.perf_counter() - t_step,
                          loss=float(loss) if at_sync else None,
                          state=state if at_sync else None)
        if ckpt_mngr is not None and ckpt_mngr.maybe_save(i, state,
                                                          loader=loader):
            gp.note_saved(i)
            write_goodput()  # flush so a later death can be costed precisely
        if watcher is not None and watcher.should_stop(i):
            preempted_at = i
            break
        if at_sync:
            now = time.perf_counter()
            gp.add("productive", now - mark, steps=i - acct)
            mark, acct = now, i
            dt = now - t0
            rate = (i - first) * items_per_step / dt
            if lead:
                print(f"[m2kt] step={i} loss={float(loss):.4f} "
                      f"{unit}={rate:.1f}", flush=True)
    sync()
    last_step = preempted_at if preempted_at is not None else STEPS
    if last_step > acct:
        gp.add("productive", time.perf_counter() - mark,
               steps=last_step - acct)
    if ckpt_mngr is not None:
        if first <= STEPS:
            # preempted: the last-chance synchronous save. Normal end:
            # the final save.
            with gp.phase("save"):
                ckpt_mngr.maybe_save(last_step, state, force=True,
                                     loader=loader)
                ckpt_mngr.close()
            gp.note_saved(last_step)
        else:
            ckpt_mngr.close()
    write_goodput()
    if watcher is not None:
        watcher.uninstall()
    torch.distributed.destroy_process_group()
    rep = gp.report()
    if preempted_at is not None:
        if lead:
            print(f"[m2kt] preempted: last-chance checkpoint at step "
                  f"{preempted_at}; goodput={rep['goodput_fraction']:.2%}",
                  flush=True)
        raise SystemExit(143)
    if lead:
        print(f"[m2kt] kernel launches "
              f"{json.dumps({k.name: k.launches for k in KERNELS})}",
              flush=True)
        total = time.perf_counter() - t0
        rate = max(0, STEPS - first) * items_per_step / total
        print(f"[m2kt] done steps={STEPS} {unit}={rate:.1f} "
              f"goodput={rep['goodput_fraction']:.2%}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
