#!/usr/bin/env python3
"""Card-side check of the PyTorch/CUDA port (``move2kube_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name
2. build: every CUDA kernel from ``move2kube_tpu_torch/csrc`` with nvcc
   for sm_90a, in parallel, with each one's registers, spills and shared
   memory, and the three flash kernels' SASS (tensor-core and TMA
   instructions in their bf16 instantiations, which must not spill)
3. each kernel against its plain PyTorch version on the card, at the
   slices' shapes in bf16, with its time, its bound and the time of
   PyTorch's own ``scaled_dot_product_attention`` (forward; forward and
   backward less forward) as a yardstick; the bf16 flash forward and
   SDPA's forward both held to the flash rule (``FLASH_PV_RTOL``); the
   bf16 backward kernels held to the backward rule (``BWD_T_RTOL``) and
   launched twice for the same bits, SDPA's backward measured against
   the same rule; the two paged-decode kernels with NaN (int8: poisoned
   rows) in the null page, launched twice for the same bits, the int8 one
   also with an fp32 query, over shared-prefix and COW-copied pages; their
   time is the device time of a CUDA graph of 200 calls (at about 17 us a
   call the host's launch time would set an event-timed loop), with the
   two passes' profiled time, the wrapper's host time, the split lengths
   of ``PAGED_SWEEP`` and b=1 on the 2048-token sequence beside it; the
   forward's logsumexp output in fp32, and the forward with its logsumexp
   in bf16 at the training slice's shape
4. engine parity at Llama-8B width and 2 layers in fp32: the engine on
   the kernels against the same weights' plain dense path; and the
   int8-kv engine against the fp32 engine from the same weights, held by
   the quant logit gate
5. the serving slice: full-depth Llama-8B in bf16 serving 16 requests on
   the engine (its default, the async pipeline with one pass a window);
   the kernels' launch counts show every prefill and decode step went
   through them
5a. async: the serving slice's model cut to SERVE_LAYERS (8) of its 32
   layers and its requests on the synchronous
   loop, the async pipeline with one and with four passes a window: the
   streams identical, the launches exactly each run's passes; each mode's
   ms a decode pass at 8 of 8 slots (host clock, device busy, dispatch
   gap) with no admission, and its dispatch gap and host_overhead_ratio
   over the 16 requests; an EOS on an interior pass of a window stopping
   every stream where the synchronous one stops, every page freed;
   int8-kv at four passes against the synchronous int8-kv loop; GPT-2
   small synchronous against four passes
5b. obs serve: the serving slice's model behind a TelemetryServer (port
   0) over the engine's registry, tracer and a UsageLedger fed by
   ``engine_source``: 4 requests with ``cost_report()`` called between two
   decode steps, the streams, pass counts and launches held to a run
   without it; ``/metrics``, ``/traces``, ``/usage``, ``/readyz`` scraped
   over HTTP (the cost families and each roofline class); one
   ``/profile?seconds=1`` capture; ``cost_report()`` on a 2-layer int8-kv
   engine at the same widths
6. the int8-kv serving slice: the same model and requests with int8
   weights and an int8 paged KV cache, every decode step's attention in
   the int8 kernel; its memory, and a profile of 4 decode steps beside
   the time the weights' dequantization takes a step
7. fleet parity at Llama-8B width and 2 layers in fp32: the prefix cache
   (hits and COW against a cache-off engine), spec decode (streams equal
   to plain greedy, alone and beside prefix hits whose suffixes outrun
   the verify window), chunked prefill (the chunked prompt's every logit
   row against the whole prefill's, every stream equal) and int8-kv with
   the prefix cache (the quant gate)
8. the fleet slice: Llama-8B's widths at SERVE_LAYERS (8) layers in bf16
   on the fleet replica's engine paths: prefix traffic on a shared
   1000-token system prompt (TTFT of hits and of the cold prompt), spec
   decode with a draft of half the layers (streams equal to plain bf16) and a 256-token chunked prefill
   beside 7 running streams (their streams equal, the chunked prompt's
   logits within the route gate of its whole prefill's); every run's
   launch counts checked exactly against the engine's own pass counters
9. fleet router parity at Llama-8B width and 2 layers in fp32: a stream
   preempted by a gold request and resumed by the router from its
   journal (one slot, stepped by hand), a mixed LoRA batch against
   single-adapter runs, a prefill replica's handoffs over the wire bytes
   against the cold engine, and a same-weights swap mid-decode (bit-equal
   logits, the version on the Completions, the prefix cache flushed)
10. the fleet router slice: ``build_fleet`` with two full-depth Llama-8B
   bf16 replicas on one card and a prefill replica, bronze traffic on 4
   system prompts, gold requests that preempt, adapter requests, long
   prompts through the disagg route and a rolling swap, all through
   ``Router.generate``; the placement, prefix hits, resumed streams
   (route gate against uninterrupted runs), adapter logits and launch
   counts checked; TTFT by tenant and route, the handoffs' bytes and
   times, the swap time, the fleet's tokens/s against one replica's; then
   an int8-kv engine auditing every second cold prefill against the bf16
   weights
11. training parity at Llama-8B width and 2 layers in fp32: 3 steps of the
   LM train step with the attention in the kernels against the plain
   dense attention, from the same weights on the same batches; then the
   same in the bf16 policy, held to source/validate.py's gates
12. the training slice: Llama-8B widths cut to 8 layers, fp32 master
   weights, the bf16 policy, AdamW, remat, head-folded cross-entropy,
   batch 4 x 2048 tokens; 5 timed steps whose launch counts show every
   layer's forward, recompute and backward went through the kernels, and
   one step under the profiler
12b. obs train: the training slice's step with the health recorder and
   StepTelemetry off and on (the overhead in % of step time); the cost
   model's FLOPs of the step held to the plain versions' count of the
   same step (``OBS_FLOPS_REL``), its MFU against the H100 row and its
   peak bytes; an Inf planted in a middle layer's gradient, named by
   ``first_bad_group`` in the ``<flight>.numerics`` sidecar and moving
   the non-finite counters by one; the ``<flight>.mem`` sidecar read back
12c. resilience: a cold bake of the kernels into a prewarm artifact and
   an empty build cache seeded from it, loaded with no nvcc; meanwhile a
   2-layer Llama-8B-width trainer (``--resilience-child``, deterministic
   algorithms) under ``python -m move2kube_tpu_torch.resilience.
   supervisor``, SIGKILLed at step 5 and resumed from its step-4
   checkpoint, beside an uninterrupted run of the same 8 steps: the final
   parameters and Adam moments equal by SHA-256; the final checkpoint
   through ``restore_variables`` served to 4 requests with the streams of
   the trainer's final state dict; each save's seconds and GB/s, the
   restore, each attempt's goodput, the exit file and the flight doc
13. the model families. GPT-2: the five kernels at GPT-2 small's
   attention (h = kvh = 12, d = 64; with the other kernel checks, after
   phase 3); parity at GPT-2 small's widths, 2 layers, fp32 (the flash
   engine against plain greedy, int8-kv with the prefix cache by the
   quant gate, spec decode, a LoRA row on the tied head); the full
   GPT-2 small (124 M) serving 16 requests in bf16 and int8-kv with
   exact launches; GPT-2 small training at full depth, batch 8 x 1024,
   and the bf16 training-parity gate at 2 layers. The MoE Llama
   (llama_8b widths, 8 experts, top-2: Mixtral-8x7B's): flash against
   dense engine parity at 2 layers in fp32, then 8 of its 32 layers in
   bf16 serving 16 requests, with the tokens each pass drops over
   capacity; one layer training at batch 2 x 2048 with the aux loss
   checked in the loss. BERT-base, ResNet-50 and the DDPM UNet, each
   through its own train step at its full config (no kernel of the port
   runs there; the loss must fall on a repeated batch)
14. emission: the port's emitter renders the Llama training and serving
   payloads (stand-ins of the JAX planner's ``llama3-8b`` and
   ``llama-serve`` services); the emitted ``port_weights.py`` ports an
   HF Llama of Llama-8B widths cut to 2 layers (numpy seed 13); the
   emitted trainer runs 10 steps of it under the port's supervisor in a
   child (deterministic algorithms) and ends with the parameters and
   Adam moments of the same 10 steps run here, by SHA-256; the emitted
   server at full-depth Llama-8B (seed-0 init), at its defaults (the
   async pipeline) and with ``M2KT_DECODE_SUBSTEPS=4``, serves 4 requests
   (one over SSE) with the in-process synchronous engine's streams, sheds
   an unmeetable deadline with a 504, keeps its warm request out of
   ``/stats`` and the SLO ledger (no diagnostic bundle), and its passes
   are what the requests imply; the emitted server on the trainer's
   checkpoint gives the streams of an engine on ``restore_variables`` of
   it; the emitted GPT-2 trainer (the ``gpt2`` sample's data=8 mesh) with
   the env of a one-card pod brings up NCCL in a world of one, prints the
   JAX trainer's one-device plan line, trains 10 steps with exact
   launches and writes the plan report on the H100 budget (predicted
   total, measured peak, drift)
15. item 9a (``mesh_phase``): two ranks of GPT-2 small at full width and
   depth share the card in a gloo group (``--mesh-rank`` children), each
   ring hop through pinned host memory, 3 steps of grad_accum 2 through
   the overlapped accumulation under the bf16 policy and fp32; after
   every step their parameters have one SHA-256, their flash launches
   are their passes, and under fp32 the loss and every parameter match a
   one-rank run on the same global batch; the step's wall time, the
   ring's seconds (host copies and gloo apart), the bytes reduced a step
   and the card's busy share beside the one-rank step
16. item 9b (``fsdp_phase``): two ranks of Llama-8B at full width, cut to
   2 layers, share the card in a gloo group (``--fsdp-rank`` children)
   and train ZeRO-3 (fsdp=2), 3 steps of grad_accum 2 under the bf16
   policy and fp32 through the prefetched schedule and 2 of fp32 through
   the sequential one; each rank's parameter and Adam moment bytes are
   the memory plan's per-device bytes; in every step each gathered leaf
   the step used holds the rank's shard as its slice and has one digest
   on both ranks, and so do the replicated leaves after it;
   the flash launches are the passes, and under fp32 the loss and every
   parameter match a one-rank run on the same global batch and the two
   schedules each other; each rank's peak against the plan and the
   one-rank fp32 run, the step's wall time, the gathers' and
   reduce-scatters' seconds and bytes and the card's busy share
17. one JSON line with every kernel's numbers, then the result line

Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

# bf16 kernel vs its plain version computed in fp32 on the same bf16
# inputs. The kernel computes in fp32 and rounds once to bf16, so it is
# held to the plain result rounded to bf16: one bf16 ulp of each value
# (at most 2**-7 of it) where the two fp32 results straddle a rounding
# boundary, plus an absolute term for fp32 sums taken in another order
# on values near zero. Long rows' outputs are ~0.04, so a kernel that
# drops or mis-merges a chunk of keys fails there too.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 3e-5
# The bf16 flash forward runs on the tensor cores with the TPU kernel's MXU
# numerics (bf16 operands, fp32 sums): it also rounds each probability to
# bf16 for P.V, which moves output i by at most 2**-8 (P.|V|)_i. Its rule:
# |out - bf16(ref)| <= BF16_ATOL + BF16_RTOL |ref| + FLASH_PV_RTOL (P.|V|),
# element by element; PyTorch's SDPA, which rounds P the same way, is held
# to it on the same inputs
FLASH_PV_RTOL = 2.0 ** -8
# The bf16 backward kernels run on the tensor cores with the TPU kernels'
# MXU numerics too: p and ds are rounded to bf16 before the products that
# make dv, dk and dq, which moves each gradient by at most 2**-8 T, T from
# ``flash_attention_bwd_abs_terms`` (|p|^T.|dO| for dv, scale |ds|^T.|q|
# for dk, both summed over each GQA group; scale |ds|.|k| for dq). Their
# rule: |x - bf16(ref)| <= BF16_ATOL + BF16_RTOL |ref| + BWD_T_RTOL T;
# SDPA's backward is measured against it on the same inputs
BWD_T_RTOL = 2.0 ** -8
# engine parity, fp32: logits of O(1) through 2 layers of width 4096 with
# the attention in the kernels vs einsums (both fp32, TF32 off), summed
# in other orders
FP32_ENGINE_ATOL = 2e-3
# the forward's logsumexp rows (O(log s), fp32 in the kernel and the plain
# version): sums in other orders, q scaled before or after the product
LSE_ATOL = 1e-4
# training parity in the bf16 policy, flash kernels vs dense attention on
# the same weights and batches: source/validate.py's gates (per-step loss,
# first-step global grad norm; relative)
BF16_TRAIN_LOSS_REL = 0.10
BF16_TRAIN_GRAD_NORM_REL = 0.15
# training parity, fp32 (TF32 off), attention in the kernels vs einsums
# and autograd: losses of ~10.9 over 3 AdamW steps at lr 1e-4 and the
# first global grad norm agree to 6.3e-8 relative on an H100 (sums in
# other orders). Each parameter's first-step gradient is held by the norm
# of its difference over its own norm, so a fault confined to a few
# leaves fails there even where the losses barely move: the worst leaf
# reads 5.4e-6 (the embedding, whose rare tokens' rows are small), and dkv
# summing only one query head of each GQA group reads 0.85 on the qkv
# projection
FP32_TRAIN_RTOL = 1e-6
FP32_GRAD_RTOL = 1e-4
# int8 paged decode with an fp32 query against its plain version in fp32:
# the same scale fold, sums in another order (the bound the JAX package's
# tests hold its Pallas int8 kernel to)
INT8_FP32_ATOL = 2e-5
# int8 weights and KV against fp32, while the greedy streams agree: the
# JAX package's quant gate (tests/test_quant.py), max |d logit| over the
# reference row's range
QUANT_GATE_REL = 0.05
# bf16 serving, one engine's two routes to the same logits (a chunked
# prefill's single-token passes through paged_decode against the whole
# prompt's flash prefill): GEMMs of other shapes round differently through
# every layer. The JAX package holds two serving routes of one engine to
# the same bound (tests/test_fleet.py, tests/test_kernels.py): max |d
# logit| over the reference row's range, on every row up to the first
# token where the streams part
ROUTE_GATE_REL = 0.05
H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
H100_BYTES_S = 3.35e12     # HBM3 (NVIDIA data sheet)
SEED = 0
# the cost model's FLOPs of the training slice's step through the kernels
# against the plain versions' count of the same step on the card: the
# same einsums and matmuls counted by torch's FlopCounterMode, so only
# fp rounding of the sums separates them
OBS_FLOPS_REL = 1e-6
# nvidia-smi's name and power limit, set by card_phase; the obs phases'
# numbers are printed beside it
CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_phase(torch) -> None:
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    CARD = smi
    log(f"nvidia-smi: {smi}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def build_phase():
    from move2kube_tpu_torch.ops import _build
    from move2kube_tpu_torch.ops.attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
        KERNELS,
    )

    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS)
    log(f"build: {len(KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if ("Compiling entry" in line or "Used" in line
                    or "spill" in line):
                log(f"  {name}: {line.strip()}")
    for kernel in (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV):
        sass_phase(_build, kernel, ptxas_usage(logs[kernel.name]))


def ptxas_usage(text: str) -> dict:
    """Each kernel function's registers and spill stores, from the
    ``-Xptxas -v`` log."""
    usage, fn = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            usage[fn] = {"registers": None, "spill_bytes": None}
        elif fn is not None and "spill stores" in line:
            usage[fn]["spill_bytes"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif fn is not None and "Used" in line and "registers" in line:
            usage[fn]["registers"] = int(
                line.split("Used")[1].split("registers")[0])
    return usage


def sass_phase(_build, kernel, usage) -> None:
    """What a flash kernel's library runs, from its SASS: per kernel
    function, its tensor-core (HGMMA), TMA (UTMALDG/UTMASTG) and fp32 FMA
    instructions, beside ptxas's registers and spills. The bf16
    instantiations (d=64 and 128, the ``_tc`` functions) must hold HGMMA
    and TMA loads and spill nothing; the build fails the phase
    otherwise."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(kernel.library_path())],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(("HGMMA", "UTMALDG", "UTMASTG",
                                        "FFMA"), 0)
        elif fn is not None:
            for op in counts[fn]:
                if f" {op}" in line:
                    counts[fn][op] += 1
    for fn, c in counts.items():
        log(f"  {kernel.name} SASS {fn}: {c}, ptxas {usage.get(fn)}")
    tc = {fn: c for fn, c in counts.items() if f"{kernel.name}_tc" in fn}
    if len(tc) != 2 or not all(
            c["HGMMA"] and c["UTMALDG"] and usage[fn]["spill_bytes"] == 0
            for fn, c in tc.items()):
        raise RuntimeError(f"{kernel.name}: the bf16 kernels (d=64, 128) "
                           f"hold no HGMMA or no TMA load, or spill: "
                           f"{counts} {usage}")


def bf16_check(torch, label: str, out, ref) -> float:
    """Hold a bf16 kernel output against its plain version in fp32 (see
    ``BF16_RTOL``); returns the max abs error against the unrounded plain
    result."""
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: non-finite output")
    want = ref.to(torch.bfloat16).float()
    excess = ((out.float() - want).abs()
              - (BF16_ATOL + BF16_RTOL * want.abs()))
    if excess.max().item() > 0:
        raise RuntimeError(
            f"{label}: {int((excess > 0).sum())} values differ from the "
            f"plain result rounded to bf16 by more than {BF16_ATOL} + "
            f"{BF16_RTOL} |x| (worst by {excess.max().item():.3e})")
    return (out.float() - ref).abs().max().item()


def flash_check(torch, label: str, out, ref, pv) -> tuple[float, float]:
    """Hold a bf16 flash forward output against the plain version in fp32
    by the flash rule (see ``FLASH_PV_RTOL``; ``pv`` is P.|V| from
    ``reference_attention_abs_v``); returns the max abs error against the
    unrounded plain result and the largest share of its allowance that
    any value uses (at most 1)."""
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: non-finite output")
    diff = (out.float() - ref.to(torch.bfloat16).float()).abs()
    allowed = BF16_ATOL + BF16_RTOL * ref.abs() + FLASH_PV_RTOL * pv
    share = (diff / allowed).max().item()
    if share > 1:
        excess = diff - allowed
        raise RuntimeError(
            f"{label}: {int((excess > 0).sum())} values differ from the "
            f"plain result rounded to bf16 by more than {BF16_ATOL} + "
            f"{BF16_RTOL} |x| + {FLASH_PV_RTOL} (P.|V|) (worst by "
            f"{excess.max().item():.3e}, {share:.3f} of its allowance)")
    return (out.float() - ref).abs().max().item(), share


def bwd_shares(torch, out, ref, term):
    """Each value's distance from the plain result rounded to bf16 over
    what the backward rule allows (see ``BWD_T_RTOL``); returns the
    largest share and the count of values past their allowance (share >
    1), and the max abs error against the unrounded plain result."""
    if not torch.isfinite(out).all():
        return float("inf"), out.numel(), float("inf")
    diff = (out.float() - ref.to(torch.bfloat16).float()).abs()
    share = diff / (BF16_ATOL + BF16_RTOL * ref.abs() + BWD_T_RTOL * term)
    return (share.max().item(), int((share > 1).sum()),
            (out.float() - ref).abs().max().item())


def _sdpa_layout(t, h):
    """[b, s, kvh, d] -> [b, h, s, d], K/V repeated up to the query heads:
    the layout PyTorch's fused attention takes."""
    return t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)


def cuda_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, cycling through
    ``arg_sets`` (copies of the inputs larger than L2 together, so each
    launch finds its inputs in device memory, as the engine does)."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured once in a
    CUDA graph (cycling through ``arg_sets``, as ``cuda_ms``) and replayed
    between two events: the kernels' own time and the gaps between them,
    without the host's time to launch them, which for a kernel of ~10 us
    is longer than the kernel."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(torch, fn, arg_sets, iters: int) -> float:
    """Host time of one call of ``fn`` in microseconds: ``iters`` calls on
    the host clock, the device left to catch up afterwards (the launches
    queue)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def pass_us(torch, fn, arg_sets, iters: int = 20) -> dict:
    """The device time per call of each kernel ``fn`` runs (by kernel
    name), from torch.profiler, in microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    return {e.key: _dev_us(e) / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_us(e) > 0}


def _copies(torch, tensors, min_bytes=200 << 20):
    per = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-min_bytes // max(per, 1)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def flash_phase(torch, h=32, kvh=8, d=128, lengths=(128, 1000, 2048)):
    """The bf16 flash forward at a prefill's shape (b=1, causal) over
    ``lengths``: checked by the flash rule (SDPA too), timed beside the
    plain version and SDPA, with its bound; one row a length."""
    import torch.nn.functional as F

    from move2kube_tpu_torch.ops import attention as att

    b = 1
    scale = d ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []
    for s in lengths:
        q = torch.randn(b, s, h, d, device="cuda", generator=gen)
        k = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
        v = torch.randn(b, s, kvh, d, device="cuda", generator=gen)
        q, k, v = (t.bfloat16() for t in (q, k, v))
        out = att.flash_attention(q, k, v, causal=True)
        ref = att.reference_attention(q.float(), k.float(), v.float(), True,
                                      scale)
        pv = att.reference_attention_abs_v(q, k, v, True, scale)
        err, share = flash_check(torch, f"flash s={s}", out, ref, pv)
        sdpa = F.scaled_dot_product_attention(
            *(_sdpa_layout(t, h) for t in (q, k, v)), is_causal=True)
        sdpa = sdpa.transpose(1, 2)
        _, sdpa_share = flash_check(torch, f"sdpa s={s} (the flash rule)",
                                    sdpa, ref, pv)
        vs_sdpa = (out.float() - sdpa.float()).abs()
        del ref, pv, sdpa
        sets = _copies(torch, (q, k, v))
        iters = 50 if s <= 1000 else 20

        def kernel(q_, k_, v_):
            return att.flash_attention(q_, k_, v_, causal=True)

        def library(q_, k_, v_):
            return F.scaled_dot_product_attention(q_, k_, v_,
                                                  is_causal=True)

        # device time by a CUDA graph of 200 calls: at s <= 1024 a call
        # takes 20-35 us, and an event-timed loop (printed beside) would
        # time the host's launches
        ms = graph_ms(torch, kernel, sets, 200)
        loop_ms = cuda_ms(torch, kernel, sets, iters)
        plain_ms = cuda_ms(torch, lambda q_, k_, v_: att.reference_attention(
            q_, k_, v_, True, scale), sets, max(5, iters // 4))
        # PyTorch's fused attention on head-major, GQA-repeated copies
        # (made outside the timing): a yardstick the port never calls
        lib_sets = [tuple(_sdpa_layout(t, h).contiguous() for t in ts)
                    for ts in sets]
        library_ms = graph_ms(torch, library, lib_sets, 200)
        ops = 2 * b * h * d * s * (s + 1)  # QK^T and PV under the mask
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        t_ops = ops / H100_BF16_FLOPS * 1e3
        t_bytes = nbytes / H100_BYTES_S * 1e3
        row = dict(s=s, err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
        log(f"flash_fwd b={b} s={s} h={h} kvh={kvh} d={d} bf16 causal: "
            f"max_abs_err {err:.3e}; largest share of the flash rule's "
            f"allowance kernel {share:.3f}, sdpa {sdpa_share:.3f}; kernel "
            f"and sdpa differ in {int((vs_sdpa > 0).sum())} of "
            f"{vs_sdpa.numel()} values, by at most "
            f"{vs_sdpa.max().item():.3e}; kernel "
            f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s; CUDA graph of 200 "
            f"calls, {loop_ms:.4f} ms by an event-timed loop) plain "
            f"{plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        del sets, lib_sets
    return rows


def _paged_geometry(b, bs, max_seq):
    """The paged phases' batch: lengths drawn from SEED in 17..max_seq
    (both ends included), disjoint page runs in a shuffled pool with 64
    pages to spare; returns (seq_lens, tables, num_pages, spare pages)."""
    import numpy as np

    mb = max_seq // bs
    rng = np.random.default_rng(SEED)
    seq_lens = rng.integers(17, max_seq + 1, size=b).astype(np.int32)
    seq_lens[0], seq_lens[1] = 17, max_seq  # both ends of the range
    need = [-(-int(n) // bs) for n in seq_lens]
    num_pages = 1 + sum(need) + 64
    order = rng.permutation(np.arange(1, num_pages)).tolist()
    tables = np.zeros((b, mb), np.int32)
    for i, n in enumerate(need):
        tables[i, :n] = [order.pop() for _ in range(n)]
    return seq_lens, tables, num_pages, order


# split lengths in tokens timed beside the planned one at the paged phases'
# shape (``paged_split_plan``'s split_tokens)
PAGED_SWEEP = (64, 128, 256)


def _live_blocks(seq_lens, kvh: int, split_tok: int) -> int:
    """Blocks of the split pass that find work: every live split of every
    (sequence, KV head); the rest of the grid returns at once."""
    return sum(kvh * max(1, -(-int(n) // split_tok)) for n in seq_lens)


def _paged_speed(torch, label, call, sets, seq_lens, kvh, bs, nbytes,
                 nbytes_b1, b1_sets):
    """A paged kernel's speed at the phase's batch: its device time per call
    by CUDA graph through the public entry point at the planned split (and
    the two passes' own device time from the profiler beside it), the
    wrapper's host time per call, the achieved GB/s, the same device time
    at each split length of ``PAGED_SWEEP``, and at b=1 on the 2048-token
    sequence alone (the old design's worst case: 8 blocks). ``call(*args,
    split_tokens=None)``: None is the public entry point. Returns the
    planned split's ms and the b=1 ms."""
    from move2kube_tpu_torch.ops import attention as att

    b, mb = len(seq_lens), sets[0][-2].shape[1]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    pps, n_split = att.paged_split_plan(b, kvh, mb, bs, sm)
    ms = graph_ms(torch, call, sets, 200)
    us = host_us(torch, call, sets, 200)
    passes = pass_us(torch, call, sets)
    sweep = []
    for st in PAGED_SWEEP:
        p, n = att.paged_split_plan(b, kvh, mb, bs, sm, st)
        t = graph_ms(torch, lambda *a: call(*a, split_tokens=st), sets, 200)
        sweep.append(f"{p * bs} tokens: {n} splits, "
                     f"{_live_blocks(seq_lens, kvh, p * bs)} of "
                     f"{n * kvh * b} blocks live, {t:.4f} ms")
    p1, n1 = att.paged_split_plan(1, kvh, mb, bs, sm)
    ms_b1 = graph_ms(torch, call, b1_sets, 200)
    passes = ", ".join(f"{_kernel_name(k)} {v:.2f}"
                       for k, v in passes.items())
    log(f"{label}: split of {pps * bs} tokens ({pps} pages), {n_split} "
        f"splits, {_live_blocks(seq_lens, kvh, pps * bs)} of "
        f"{n_split * kvh * b} blocks live on {sm} SMs; device "
        f"{ms:.4f} ms a call (CUDA graph of 200 calls), "
        f"{nbytes / ms / 1e6:.1f} GB/s; passes by the profiler (us a call;"
        f" the merge's span includes its blocks' wait for the split pass): "
        f"{passes}; wrapper host {us:.1f} us a call")
    log(f"{label}: sweep: {'; '.join(sweep)}")
    log(f"{label}: b=1 on the {int(seq_lens.max())}-token sequence: split "
        f"of {p1 * bs} "
        f"tokens, {n1} splits, {n1 * kvh} blocks live; {ms_b1:.4f} ms, "
        f"{nbytes_b1 / ms_b1 / 1e6:.1f} GB/s, bound "
        f"{nbytes_b1 / H100_BYTES_S * 1e3:.4f} ms (bytes)")
    return ms, ms_b1


def _kernel_name(key: str) -> str:
    """``void ns::kernel<args>(params)`` as the profiler names it ->
    ``kernel<args>``."""
    return key.split(">(")[0].split("::")[-1] + ">"


def _same_bits(torch, label, fn, args):
    """Two launches on the same inputs give the same bits (the merge runs
    in a fixed order, with no atomics)."""
    a, b = fn(*args), fn(*args)
    if not torch.equal(a, b):
        raise RuntimeError(f"{label}: two launches differ in "
                           f"{int((a != b).sum())} values")


def _paged_bytes(seq_lens, kvh, row_bytes, q_numel, tables):
    """What a paged call must move: each live token's K and V rows (and
    scales), q in and o out in bf16, the tables and lengths."""
    return (int(sum(seq_lens)) * kvh * row_bytes * 2 + 2 * q_numel * 2
            + tables.nbytes + 4 * len(seq_lens))


def paged_phase(torch, h=32, kvh=8, d=128, max_seq=2048):
    from move2kube_tpu_torch.ops import attention as att

    b, bs = 8, 16
    scale = d ** -0.5
    seq_lens, tables, num_pages, _ = _paged_geometry(b, bs, max_seq)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    q = torch.randn(b, h, d, device="cuda", generator=gen).bfloat16()
    kp = torch.randn(num_pages, bs, kvh, d, device="cuda",
                     generator=gen).bfloat16()
    vp = torch.randn(num_pages, bs, kvh, d, device="cuda",
                     generator=gen).bfloat16()
    bt = torch.from_numpy(tables).cuda()
    sl = torch.from_numpy(seq_lens).cuda()
    kp[0] = 0
    vp[0] = 0
    ref = att.paged_decode_reference(q.float(), kp.float(), vp.float(), bt,
                                     sl, scale)
    # the null page holds NaN for the kernel: it must never be read
    kp[0] = float("nan")
    vp[0] = float("nan")
    out = att.paged_decode_attention(q, kp, vp, bt, sl)
    err = bf16_check(torch, "paged_decode (NaN in the null page)", out, ref)
    _same_bits(torch, "paged_decode", att.paged_decode_attention,
               (q, kp, vp, bt, sl))
    long_row = int(seq_lens.argmax())
    # b=1, as a chunk pass calls it: the planner splits one sequence
    # more finely than the batch of 8
    for r in (0, long_row):
        err = max(err, bf16_check(
            torch, f"paged_decode b=1 ({seq_lens[r]} tokens)",
            att.paged_decode_attention(q[r:r + 1], kp, vp,
                                       bt[r:r + 1].contiguous(),
                                       sl[r:r + 1].contiguous()),
            ref[r:r + 1]))

    def call(*a, split_tokens=None):
        if split_tokens is None:
            return att.paged_decode_attention(*a)
        return att._paged_decode_cuda(*a, scale, split_tokens)

    sets = _copies(torch, (q, kp, vp, bt, sl))
    b1_sets = [(q_[long_row:long_row + 1], k_, v_,
                t_[long_row:long_row + 1].contiguous(),
                n_[long_row:long_row + 1].contiguous())
               for q_, k_, v_, t_, n_ in sets]
    nbytes = _paged_bytes(seq_lens, kvh, d * 2, q.numel(), tables)
    ms, ms_b1 = _paged_speed(
        torch, "paged_decode", call, sets, seq_lens, kvh, bs, nbytes,
        _paged_bytes(seq_lens[long_row:long_row + 1], kvh, d * 2, h * d,
                     tables[long_row:long_row + 1]), b1_sets)
    del sets, b1_sets
    plain_ms = cuda_ms(torch, lambda *a: att.paged_decode_reference(
        *a, scale), [(q, kp.nan_to_num(0.0), vp.nan_to_num(0.0), bt, sl)] * 2,
        20)
    ops = 4 * int(seq_lens.sum()) * h * d
    t_ops = ops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_S * 1e3
    row = dict(err=err, ms=ms, ms_b1=ms_b1, plain_ms=plain_ms,
               library_ms=None, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"paged_decode b={b} h={h} kvh={kvh} d={d} bs={bs} seq_lens "
        f"{seq_lens.tolist()} bf16, and b=1 on rows of {seq_lens[0]} and "
        f"{seq_lens[long_row]} tokens: max_abs_err {err:.3e} (within "
        f"{BF16_ATOL} + {BF16_RTOL} |x| of the plain result rounded to "
        f"bf16), the same bits over two launches; kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, {100 * row['bound_ms'] / ms:.1f}% of it)")
    return row


def paged_int8_phase(torch, h=32, kvh=8, d=128, max_seq=2048):
    """The int8 paged-decode kernel at paged_phase's batch: pools from
    ``quantize_kv_rows`` of random rows, a bf16 and an fp32 query, NaN
    scales and +-127 rows in the null page (the kernel must never read
    it; the plain version runs on a copy whose null page is zeroed, as
    0 * NaN is NaN in its fold), then a shared-prefix pair and a COW-copied
    page; the same bits over two launches; speed as paged_phase's."""
    from move2kube_tpu_torch.ops import attention as att
    from move2kube_tpu_torch.serving.kvcache import copy_page

    b, bs = 8, 16
    scale = d ** -0.5
    seq_lens, tables, num_pages, spare = _paged_geometry(b, bs, max_seq)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    q = torch.randn(b, h, d, device="cuda", generator=gen).bfloat16()
    k8, ks = att.quantize_kv_rows(torch.randn(
        num_pages, bs, kvh, d, device="cuda", generator=gen))
    v8, vs = att.quantize_kv_rows(torch.randn(
        num_pages, bs, kvh, d, device="cuda", generator=gen))
    bt = torch.from_numpy(tables).cuda()
    sl = torch.from_numpy(seq_lens).cuda()
    pools = (k8, v8, ks, vs)
    for t in pools:
        t[0] = 0
    clean = tuple(t.clone() for t in pools)
    ref = att.paged_decode_int8_reference(q.float(), *clean, bt, sl, scale)
    sign = torch.where(torch.arange(d, device="cuda") % 2 == 0, 127, -127)
    k8[0] = sign.to(torch.int8)
    v8[0] = (-sign).to(torch.int8)
    ks[0] = float("nan")
    vs[0] = float("nan")

    def kernel(q_, k_, v_, ks_, vs_, bt_, sl_):
        return att.paged_decode_attention(q_, k_, v_, bt_, sl_, k_scale=ks_,
                                          v_scale=vs_)

    err = bf16_check(torch, "paged_decode_int8 (bf16 q, poisoned null "
                     "page)", kernel(q, *pools, bt, sl), ref)
    err32 = (kernel(q.float(), *pools, bt, sl) - ref).abs().max().item()
    _same_bits(torch, "paged_decode_int8", kernel, (q, *pools, bt, sl))
    long_row = int(seq_lens.argmax())
    for r in (0, long_row):  # b=1, as a chunk pass calls it
        err = max(err, bf16_check(
            torch, f"paged_decode_int8 b=1 ({seq_lens[r]} tokens)",
            kernel(q[r:r + 1], *pools, bt[r:r + 1].contiguous(),
                   sl[r:r + 1].contiguous()), ref[r:r + 1]))
    # a shared prefix and a COW copy: rows 0 and 1 read sequence 1's first
    # 1000 tokens, row 1 through a copy of its 11th page; row 2 its first
    # 500 with another query
    cow = spare[0]
    copy_page({"k": [k8], "v": [v8], "k_scale": [ks], "v_scale": [vs]},
              int(tables[1, 10]), cow)
    copy_page({"k": [clean[0]], "v": [clean[1]], "k_scale": [clean[2]],
               "v_scale": [clean[3]]}, int(tables[1, 10]), cow)
    bt3 = bt[[1, 1, 1]].clone()
    bt3[1, 10] = cow
    sl3 = torch.tensor([1000, 1000, 500], dtype=torch.int32, device="cuda")
    q3 = q.float()[[1, 1, 2]].contiguous()
    out3 = kernel(q3, *pools, bt3, sl3)
    ref3 = att.paged_decode_int8_reference(q3, *clean, bt3, sl3, scale)
    err3 = (out3 - ref3).abs().max().item()
    if not (err32 <= INT8_FP32_ATOL and err3 <= INT8_FP32_ATOL
            and torch.equal(out3[0], out3[1])):
        raise RuntimeError(
            f"paged_decode_int8 fp32 q: max abs err {err32:.3e}, shared/COW"
            f" rows {err3:.3e} (tol {INT8_FP32_ATOL}); COW row equal to its"
            f" original: {torch.equal(out3[0], out3[1])}")

    def call(*a, split_tokens=None):
        if split_tokens is None:
            return kernel(*a)
        return att._paged_decode_int8_cuda(*a, scale, split_tokens)

    sets = _copies(torch, (q, *pools, bt, sl))
    b1_sets = [(s_[0][long_row:long_row + 1], *s_[1:5],
                s_[5][long_row:long_row + 1].contiguous(),
                s_[6][long_row:long_row + 1].contiguous()) for s_ in sets]
    # int8 K and V rows and their fp32 scales, q in, o out, tables
    nbytes = _paged_bytes(seq_lens, kvh, d + 4, q.numel(), tables)
    ms, ms_b1 = _paged_speed(
        torch, "paged_decode_int8", call, sets, seq_lens, kvh, bs, nbytes,
        _paged_bytes(seq_lens[long_row:long_row + 1], kvh, d + 4, h * d,
                     tables[long_row:long_row + 1]), b1_sets)
    del sets, b1_sets
    plain_ms = cuda_ms(torch, lambda *a: att.paged_decode_int8_reference(
        *a, scale), [(q, *clean, bt, sl)] * 2, 20)
    ops = 4 * int(seq_lens.sum()) * h * d
    t_ops = ops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_S * 1e3
    row = dict(err=max(err, err32, err3), ms=ms, ms_b1=ms_b1,
               plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"paged_decode_int8 b={b} h={h} kvh={kvh} d={d} bs={bs} seq_lens "
        f"{seq_lens.tolist()} int8 pools: bf16 q (and b=1 on rows of "
        f"{seq_lens[0]} and {seq_lens[long_row]} tokens) max_abs_err "
        f"{err:.3e} "
        f"(within {BF16_ATOL} + {BF16_RTOL} |x| of the plain result rounded"
        f" to bf16), fp32 q {err32:.3e}, shared-prefix / COW rows "
        f"{err3:.3e} (tol {INT8_FP32_ATOL}), COW row bit-equal, the same "
        f"bits over two launches; kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{100 * row['bound_ms'] / ms:.1f}% of it)")
    return row


def lse_phase(torch) -> float:
    """The forward kernel's logsumexp output (fp32, a ragged length)
    against the plain version's."""
    from move2kube_tpu_torch.ops import attention as att

    b, s, h, kvh, d = 2, 1000, 32, 8, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=gen)
               for n in (h, kvh, kvh))
    out, lse = att.flash_attention_fwd(q, k, v, True, d ** -0.5)
    ref, ref_lse = att.reference_attention_lse(q, k, v, True, d ** -0.5)
    err = (lse - ref_lse).abs().max().item()
    out_err = (out - ref).abs().max().item()
    if not err <= LSE_ATOL or not out_err <= 1e-4:
        raise RuntimeError(f"flash_fwd lse: max abs err {err:.3e} (tol "
                           f"{LSE_ATOL}), output {out_err:.3e} (tol 1e-4)")
    log(f"flash_fwd lse b={b} s={s} h={h} kvh={kvh} d={d} fp32 causal: "
        f"max abs err {err:.3e} (tol {LSE_ATOL}), output {out_err:.3e}")
    return err


def bwd_phase(torch, b=4, s=2048, h=32, kvh=8, d=128):
    """The backward kernels in bf16 at the training slice's attention shape
    against the plain backward by the backward rule (SDPA's backward's
    share of the same allowance beside theirs), bit-identical over two
    launches, each with its time, its bound, the plain backward's time and
    SDPA's backward as a yardstick; and the forward
    with its lse at the same shape, checked by the flash rule (SDPA's
    forward too) and timed beside SDPA's forward, with its bound."""
    import torch.nn.functional as F

    from move2kube_tpu_torch.ops import attention as att

    scale = d ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    q, k, v, g = (torch.randn(b, s, n, d, device="cuda", generator=gen)
                  .bfloat16() for n in (h, kvh, kvh, h))
    o32, lse = att.reference_attention_lse(q.float(), k.float(), v.float(),
                                           True, scale)
    # the forward as the training slice launches it: bf16, b=4, with lse;
    # SDPA's forward held to the same rule on the same inputs
    o_k, lse_k = att.flash_attention_fwd(q, k, v, True, scale)
    pv = att.reference_attention_abs_v(q, k, v, True, scale)
    fwd_err, fwd_share = flash_check(
        torch, "flash_fwd with lse (training shape)", o_k, o32, pv)
    sdpa = F.scaled_dot_product_attention(
        *(_sdpa_layout(t, h) for t in (q, k, v)), is_causal=True)
    _, sdpa_share = flash_check(torch, "sdpa (training shape, the flash "
                                "rule)", sdpa.transpose(1, 2), o32, pv)
    del pv, sdpa
    lse_err = (lse_k - lse).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise RuntimeError(f"flash_fwd lse (training shape, bf16): max abs "
                           f"err {lse_err:.3e} > {LSE_ATOL}")
    o = o32.bfloat16()
    del o32, o_k, lse_k
    delta = att.flash_bwd_delta(o, g)
    got = [att.flash_bwd_dq(q, k, v, g, lse, delta, True, scale),
           *att.flash_bwd_dkv(q, k, v, g, lse, delta, True, scale)]
    # a second launch on the same inputs gives the same bits: no atomics
    again = [att.flash_bwd_dq(q, k, v, g, lse, delta, True, scale),
             *att.flash_bwd_dkv(q, k, v, g, lse, delta, True, scale)]
    same = [torch.equal(a, b_) for a, b_ in zip(got, again)]
    del again
    # SDPA's backward on the same inputs, K/V repeated inside the graph
    # (so autograd sums dk/dv over each group): a yardstick measured
    # against the same rule, never called by the port
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(
        *(_sdpa_layout(t, h) for t in leaves), is_causal=True)
    sdpa = torch.autograd.grad(out.transpose(1, 2), leaves, g)
    del out, leaves
    want = att.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, g.float(), True,
        scale)
    terms = att.flash_attention_bwd_abs_terms(q, k, v, o, lse, g, True,
                                              scale)
    errs, shares, sdpa_shares = {}, {}, {}
    for name, x, y, t, z in zip("q k v".split(), got, want, terms, sdpa):
        shares[name], n_out, errs[name] = bwd_shares(torch, x, y, t)
        sdpa_shares[name] = bwd_shares(torch, z, y, t)[:2]
        if n_out:
            raise RuntimeError(
                f"flash_bwd d{name}: {n_out} values differ from the plain "
                f"result rounded to bf16 by more than {BF16_ATOL} + "
                f"{BF16_RTOL} |x| + {BWD_T_RTOL} T ({shares[name]:.3f} of "
                "the allowance at worst)")
    if not all(same):
        raise RuntimeError(f"flash backward: dq, dk, dv bit-identical over "
                           f"two launches: {same}")
    del want, terms, got, sdpa
    sets = _copies(torch, (q, k, v, g, lse, delta))
    ms_dq = cuda_ms(torch, lambda *a: att.flash_bwd_dq(*a, True, scale),
                    sets, 10)
    ms_dkv = cuda_ms(torch, lambda *a: att.flash_bwd_dkv(*a, True, scale),
                     sets, 10)
    ms_fwd = cuda_ms(torch, lambda q_, k_, v_, *_: att.flash_attention_fwd(
        q_, k_, v_, True, scale), sets, 10)
    plain_sets = [(q_, k_, v_, o, lse_, g_)
                  for q_, k_, v_, g_, lse_, _ in sets[:2]]
    plain_ms = cuda_ms(torch, lambda *a: att.flash_attention_bwd_reference(
        *a, True, scale), plain_sets, 4)
    del plain_sets

    # SDPA forward+backward less its forward, on head-major, GQA-repeated
    # copies with grad (made outside the timing): a yardstick the port
    # never calls
    def lib_copy(t):
        t = t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
        return t.contiguous().requires_grad_()

    lib_sets = [tuple(lib_copy(t) for t in ts[:3])
                + (ts[3].transpose(1, 2).contiguous(),) for ts in sets]

    def sdpa_fwd(q_, k_, v_, g_):
        with torch.no_grad():
            F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

    def sdpa_fwd_bwd(q_, k_, v_, g_):
        out = F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)
        torch.autograd.grad(out, (q_, k_, v_), g_)

    sdpa_fwd_ms = cuda_ms(torch, sdpa_fwd, lib_sets, 10)
    library_ms = cuda_ms(torch, sdpa_fwd_bwd, lib_sets, 10) - sdpa_fwd_ms
    del lib_sets, sets
    # bounds: each input read once, each output written once; operations
    # under the causal mask, a product of the forward's size being
    # 2 * b * h * d * s * (s + 1) / 2 FLOPs: dq does 3 (q.k^T, dO.v^T,
    # ds.k), dkv 4 (q.k^T, dO.v^T, p^T.dO, ds^T.q)
    product = b * h * d * s * (s + 1)
    in_bytes = ((q.numel() + k.numel() + v.numel() + g.numel()) * 2
                + (lse.numel() + delta.numel()) * 4)
    rows = {}
    for name, ms, n_products, out_bytes in (
            ("flash_bwd_dq", ms_dq, 3, q.numel() * 2),
            ("flash_bwd_dkv", ms_dkv, 4, (k.numel() + v.numel()) * 2)):
        t_ops = n_products * product / H100_BF16_FLOPS * 1e3
        t_bytes = (in_bytes + out_bytes) / H100_BYTES_S * 1e3
        rows[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            err=errs["q"] if name == "flash_bwd_dq" else max(errs["k"],
                                                             errs["v"]))
    # the forward with its lse: QK^T and PV under the mask; q, k, v read,
    # o and lse written
    t_ops = 2 * product / H100_BF16_FLOPS * 1e3
    t_bytes = ((2 * q.numel() + k.numel() + v.numel()) * 2
               + lse.numel() * 4) / H100_BYTES_S * 1e3
    rows["flash_fwd"] = dict(
        ms=ms_fwd, err=max(fwd_err, lse_err), library_ms=sdpa_fwd_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"flash_fwd with lse b={b} s={s} h={h} kvh={kvh} d={d} bf16 causal:"
        f" output max abs err {fwd_err:.3e}; largest share of the flash "
        f"rule's allowance kernel {fwd_share:.3f}, sdpa {sdpa_share:.3f}; "
        f"lse max abs err {lse_err:.3e} (tol {LSE_ATOL}); kernel "
        f"{ms_fwd:.4f} ms "
        f"({2 * product / ms_fwd / 1e9:.1f} TFLOP/s) sdpa forward "
        f"{sdpa_fwd_ms:.4f} ms bound {rows['flash_fwd']['bound_ms']:.4f} ms"
        f" ({rows['flash_fwd']['bound_by']})")
    log(f"flash backward b={b} s={s} h={h} kvh={kvh} d={d} bf16 causal: "
        f"max abs err dq {errs['q']:.3e} dk {errs['k']:.3e} dv "
        f"{errs['v']:.3e}; largest share of the backward rule's allowance "
        f"(within {BF16_ATOL} + {BF16_RTOL} |x| + {BWD_T_RTOL} T of the "
        f"plain fp32 result rounded to bf16) kernels "
        + ", ".join(f"d{n} {shares[n]:.3f}" for n in "qkv")
        + "; sdpa " + ", ".join(
            f"d{n} {sdpa_shares[n][0]:.3f} ({sdpa_shares[n][1]} values past "
            "it)" for n in "qkv")
        + f"; dq, dk, dv bit-identical over two launches; dq {ms_dq:.4f} ms"
        f" ({3 * product / ms_dq / 1e9:.1f} TFLOP/s, bound "
        f"{rows['flash_bwd_dq']['bound_ms']:.4f}), dkv {ms_dkv:.4f} ms "
        f"({4 * product / ms_dkv / 1e9:.1f} TFLOP/s, bound "
        f"{rows['flash_bwd_dkv']['bound_ms']:.4f}); plain backward "
        f"{plain_ms:.4f} ms; sdpa backward {library_ms:.4f} ms; flash_fwd "
        f"with lse at this shape {ms_fwd:.4f} ms")
    return rows


def _greedy_dense(torch, model, prompt, n, lora=None):
    """Greedy continuation by full forwards of the plain dense path (with
    the multi-LoRA operand ``lora``, if given); returns the tokens and the
    logits rows each was argmaxed from."""
    toks, rows = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            logits = model(torch.tensor([toks], device="cuda"),
                           lora=lora)[0, -1]
            rows.append(logits)
            toks.append(int(torch.argmax(logits)))
    return toks[len(prompt):], rows


def parity_phase(torch):
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Llama,
        Request,
        ServingEngine,
        init_llama,
        llama_8b,
    )

    cfg = dataclasses.replace(llama_8b(), num_layers=2, dtype=torch.float32,
                              attn_impl="flash")
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    plain = Llama(dataclasses.replace(cfg, attn_impl="dense"), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain.eval()
    rng = np.random.default_rng(SEED + 1)
    lengths, n_new = (37, 300, 777, 1200), 8
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in lengths]
    eng = ServingEngine(model, EngineConfig(max_batch=4, max_seq=1280,
                                            block_size=16), device="cuda")
    eng.capture_logits = True
    comps = {c.rid: c for c in eng.run(
        [Request(f"p{i}", p, n_new) for i, p in enumerate(prompts)])}
    worst = 0.0
    for i, p in enumerate(prompts):
        want, rows = _greedy_dense(torch, plain, p, n_new)
        got = comps[f"p{i}"].tokens
        if got != want:
            raise RuntimeError(f"parity: prompt {i} (len {len(p)}) stream "
                               f"{got} != plain {want}")
        # prefill logits, then the first decode step's
        for j in (0, 1):
            err = float(np.abs(eng.logit_log[f"p{i}"][j]
                               - rows[j].float().cpu().numpy()).max())
            worst = max(worst, err)
            if err > FP32_ENGINE_ATOL:
                raise RuntimeError(
                    f"parity: prompt {i} logits row {j} max abs err {err} "
                    f"> {FP32_ENGINE_ATOL}")
    log(f"parity: llama_8b widths, 2 layers, fp32, prompts {list(lengths)}"
        f" x {n_new} tokens: streams identical, prefill/first-decode "
        f"logits max abs err {worst:.3e} (tol {FP32_ENGINE_ATOL})")
    ref = ({rid: c.tokens for rid, c in comps.items()}, eng.logit_log)
    del eng, plain
    torch.cuda.empty_cache()
    quant_gate_phase(torch, model, prompts, n_new, ref)
    del model
    torch.cuda.empty_cache()


def quant_gate_phase(torch, model, prompts, n_new, ref) -> None:
    """The int8-kv engine (int8 weights, int8 cache, the int8 decode
    kernel) against the fp32 engine's run ``ref`` (tokens and logit rows
    by request) on the same fp32 weights: over each request's agreed
    greedy prefix (and the first row after it) the logits stay within the
    quant gate."""
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        logit_gate,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.ops.attention import PAGED_DECODE_INT8

    reset_launch_counts()
    eng = ServingEngine(model, EngineConfig(
        max_batch=4, max_seq=1280, block_size=16, quant="int8-kv"),
        device="cuda")
    eng.capture_logits = True
    got = {c.rid: c.tokens for c in eng.run(
        [Request(f"p{i}", p, n_new) for i, p in enumerate(prompts)])}
    got_log = eng.logit_log
    del eng
    if PAGED_DECODE_INT8.launches == 0:
        raise RuntimeError("quant gate: the int8-kv engine never launched "
                           "paged_decode_int8")
    ref, ref_log = ref
    worst, rows, agreed = 0.0, 0, []
    for rid, a_t in ref.items():
        agree = _greedy_prefix(a_t, got[rid])
        agreed.append(agree)
        for i in range(min(agree + 1, len(ref_log[rid]),
                           len(got_log[rid]))):
            gate = logit_gate(ref_log[rid][i], got_log[rid][i])
            worst = max(worst, gate["max_rel_err"])
            rows += 1
    if not (worst < QUANT_GATE_REL and rows >= len(prompts)):
        raise RuntimeError(f"quant gate: int8-kv vs fp32 max rel err "
                           f"{worst:.4f} over {rows} rows (tol "
                           f"{QUANT_GATE_REL}); agreed tokens {agreed}")
    log(f"quant gate: llama_8b widths, 2 layers, fp32 weights, int8-kv "
        f"engine vs fp32 engine, prompts {[len(p) for p in prompts]} x "
        f"{n_new} tokens: greedy tokens agreed {agreed} of {n_new}, max rel"
        f" logit err {worst:.4f} over {rows} rows (tol {QUANT_GATE_REL}); "
        f"paged_decode_int8 launched {PAGED_DECODE_INT8.launches} times")


def _slice_prompts(vocab: int, max_prompt: int):
    """The serving slices' 16 prompts (lengths from seed 2 in
    64..``max_prompt``), and the generator that drew them."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    lengths = rng.integers(64, max_prompt + 1, size=16)
    return [rng.integers(1, vocab, size=int(n)).tolist()
            for n in lengths], rng


def _serve_slice(torch, model, econf, label: str, decode_kernel: str,
                 max_prompt: int = 1536, n_new: int = 64,
                 keep_logits: bool = False):
    """The serving slices' run: a warm-up on its own engine (first-call
    costs stay out of the numbers), then 16 requests submitted at once
    (prompt lengths drawn from seed 2 in 64..``max_prompt``, ``n_new`` new
    tokens each) on a fresh engine with every launch count set to 0 just
    before. Checks that every request completed with finite logits and
    that each layer launched ``flash_fwd`` once a prefill and
    ``decode_kernel`` once a decode step, and nothing else; prints the
    numbers (TTFT p50/p95 from each request's first token), then profiles
    a prefill and 4 decode steps. Returns the launch counts, one decode
    step's profiled device busy time in ms, and (``keep_logits``) each
    request's tokens and logit rows by rid, else None."""
    import numpy as np

    from move2kube_tpu_torch import (
        Request,
        ServingEngine,
        param_bytes,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.ops.attention import KERNELS

    cfg = model.cfg
    ServingEngine(model, econf, device="cuda").run(
        [Request("warm", list(range(1, 65)), 4)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts, rng = _slice_prompts(cfg.vocab_size, max_prompt)
    lengths = np.array([len(p) for p in prompts])
    reqs = [Request(f"r{i}", p, n_new) for i, p in enumerate(prompts)]
    eng = ServingEngine(model, econf, device="cuda")
    eng.capture_logits = True
    first: dict = {}
    eng.on_token = lambda rid, _tok: first.setdefault(
        rid, time.perf_counter())
    reset_launch_counts()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    stats = eng.stats()
    if len(comps) != 16 or any(len(c.tokens) != n_new for c in comps):
        raise RuntimeError(f"{label}: not every request completed with "
                           f"{n_new} tokens")
    for rid, rows in eng.logit_log.items():
        if not all(np.isfinite(r).all() for r in rows):
            raise RuntimeError(f"{label}: non-finite logits for {rid}")
    want = {k.name: 0 for k in KERNELS}
    want["flash_fwd"] = cfg.num_layers * stats["prefills"]
    want[decode_kernel] = cfg.num_layers * stats["decode_steps"]
    if launches != want or stats["prefills"] != 16:
        raise RuntimeError(f"{label}: launches {launches}, expected {want} "
                           f"({stats['prefills']} prefills, "
                           f"{stats['decode_steps']} decode steps)")
    generated = sum(len(c.tokens) for c in comps)
    resident = param_bytes(eng.model)  # the engine's copy (int8 if quant)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv_bytes = sum(t.numel() * t.element_size()
                   for pools in eng._cache.values()
                   if isinstance(pools, list) for t in pools)
    ttft = sorted(first[r.rid] - t0 for r in reqs)
    log(f"{label}: 16 requests, prompts {sorted(lengths.tolist())}, {n_new} "
        f"new tokens each, max_batch {econf.max_batch}, quant {econf.quant}:"
        f" wall {wall:.3f} s,"
        f" {generated / wall:.1f} tokens/s overall, decode "
        f"{stats['decode_throughput_tokens_s']:.1f} tokens/s over "
        f"{stats['decode_steps']} steps "
        f"({stats['decode_time_s'] / stats['decode_steps'] * 1e3:.2f} "
        f"ms/step), {stats['prefills']} prefills in "
        f"{stats['prefill_time_s']:.3f} s, mean TTFT "
        f"{stats['ttft_mean_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f} "
        f"ms, all submitted at once; p50 {_pctl(ttft, 50):.1f} ms, "
        f"p95 {_pctl(ttft, 95):.1f} ms); resident parameters "
        f"{resident / 1e9:.3f} GB, KV pools {kv_bytes / 1e9:.3f} "
        f"GB, peak memory {peak:.2f} GiB")
    log(f"{label}: launches {launches} = {cfg.num_layers} layers x "
        f"({stats['prefills']} prefills, {stats['decode_steps']} decode "
        "steps)")
    run = ({c.rid: (c.tokens, eng.logit_log[c.rid]) for c in comps}
           if keep_logits else None)
    del eng
    return launches, profile_phase(torch, model, econf, rng), run


def slice_phase(torch):
    """The serving slice; returns its launch counts and the model, which
    the fleet slice serves again."""
    from move2kube_tpu_torch import EngineConfig, init_llama, llama_8b

    cfg = dataclasses.replace(llama_8b(), attn_impl="flash")
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    torch.cuda.synchronize()
    log(f"slice: llama_8b, attn_impl='flash', bf16 weights drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    return _serve_slice(torch, model, econf, "slice",
                        "paged_decode")[0], model


def int8_slice_phase(torch):
    """The int8-kv slice: the serving slice's model (seed 0, bf16) and
    requests with ``quant="int8-kv"``. The bf16 weights are quantized and
    freed before any engine runs; each engine the slice builds leaves the
    already-quantized layers as they are."""
    from move2kube_tpu_torch import (
        EngineConfig,
        QuantLinear,
        init_llama,
        llama_8b,
        quantize_model,
    )

    cfg = dataclasses.replace(llama_8b(), attn_impl="flash")
    t0 = time.perf_counter()
    model = quantize_model(init_llama(cfg, seed=SEED, device="cuda").eval())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"int8 slice: llama_8b bf16 weights drawn and quantized to int8 on "
        f"the card in {time.perf_counter() - t0:.1f} s; the bf16 weights "
        "are freed")
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16,
                         quant="int8-kv")
    launches, busy, _ = _serve_slice(torch, model, econf, "int8 slice",
                                     "paged_decode_int8")
    # the dequantization a decode step runs, alone: every int8 weight to
    # its compute type once
    qlinears = [m for m in model.modules() if isinstance(m, QuantLinear)]
    dq_ms = cuda_ms(torch, lambda: [m.dequantized() for m in qlinears],
                    [()], 5)
    if not busy > 0:
        raise RuntimeError("int8 slice: the profiler saw no device time")
    log(f"int8 slice: dequantizing all {len(qlinears)} int8 weights, as "
        f"each step does, takes {dq_ms:.3f} ms on its own: "
        f"{100 * dq_ms / busy:.1f}% of a profiled decode step's device busy"
        f" time ({busy:.3f} ms)")
    return launches


def _expected_launches(stats, layers: int, draft_layers: int) -> dict:
    """What the attention kernels' launch counts must come to after an
    engine run, from the engine's own pass counters: one kernel a layer
    a pass; flash for the prefills and the quant audit's fp forwards, the
    paged kernel for every single-token pass (decode steps, prefix-hit
    suffix feeding, verify, chunk, draft)."""
    p = stats["passes"]
    return {"flash_fwd": layers * (p["prefill"] + p["audit"])
            + draft_layers * p["draft_prefill"],
            "paged": layers * (p["decode"] + p["verify"] + p["chunk"])
            + draft_layers * p["draft_decode"]}


def _engine_run(torch, model, econf, reqs, label, tracer=None):
    """One run on a fresh engine with every launch count set to 0 just
    before and read just after; checks the counts exactly against the
    engine's pass counters (the paged kernel of the engine's cache type,
    no other kernel). Returns the engine, its completions by rid, and
    the counts."""
    from move2kube_tpu_torch import ServingEngine, reset_launch_counts
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.serving.quant import draft_config

    eng = ServingEngine(model, econf, device="cuda", tracer=tracer)
    eng.capture_logits = True
    reset_launch_counts()
    t0 = time.perf_counter()
    comps = {c.rid: c for c in eng.run(reqs)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    stats = eng.stats()
    layers = model.cfg.num_layers
    draft_layers = (draft_config(model.cfg, econf.spec_draft_factor)
                    .num_layers if econf.spec_k else 0)
    exp = _expected_launches(stats, layers, draft_layers)
    paged = "paged_decode_int8" if econf.quant == "int8-kv" else (
        "paged_decode")
    want = {k.name: 0 for k in KERNELS}
    want["flash_fwd"] = exp["flash_fwd"]
    want[paged] = exp["paged"]
    if launches != want:
        raise RuntimeError(f"{label}: launches {launches}, expected {want} "
                           f"from passes {stats['passes']}")
    if len(comps) != len(reqs):
        raise RuntimeError(f"{label}: {len(comps)} of {len(reqs)} requests "
                           "completed")
    return eng, comps, launches, wall


# the async decode pipeline's phase: decode passes timed and profiled at
# 8 of 8 slots in each mode, and the modes it runs (the engine's own
# config fields)
ASYNC_NEW, ASYNC_TIMED, ASYNC_PROFILED = 64, 16, 4
ASYNC_MODES = (("sync", {"async_decode": "off"}),
               ("async N=1", {"async_decode": "on", "substeps": 1}),
               ("async N=4", {"async_decode": "on", "substeps": 4}))


def _slice_requests(vocab: int, max_prompt: int = 1536):
    """The serving slice's 16 requests, as fresh ``Request`` objects."""
    from move2kube_tpu_torch import Request

    prompts, _ = _slice_prompts(vocab, max_prompt)
    return lambda: [Request(f"r{i}", list(p), ASYNC_NEW)
                    for i, p in enumerate(prompts)]


def _steady(torch, model, econf, label: str, modes) -> dict:
    """Each mode's engine with eight 512-token requests seated at once and
    its pipeline filled (two engine steps); then ``ASYNC_TIMED`` decode
    passes of each mode on the host's clock with the dispatch gap they
    add, in two rounds, the second in the reverse order (host time drifts
    between calls, so each mode is read twice, beside the others), each
    after one untimed step; then
    ``ASYNC_PROFILED`` passes of each under torch.profiler. No admission
    happens. Returns ms a decode pass by mode: the two walls, device busy
    and the dispatch gap."""
    import numpy as np

    from move2kube_tpu_torch import Request, ServingEngine

    engines = {}
    for mode, over in modes:
        rng = np.random.default_rng(SEED + 3)
        eng = ServingEngine(model, dataclasses.replace(
            econf, admit_burst=0, **over), device="cuda")
        for i in range(8):
            eng.submit(Request(f"s{i}", rng.integers(
                1, model.cfg.vocab_size, size=512).tolist(), ASYNC_NEW))
        eng.step()
        eng.step()
        engines[mode] = eng
    out = {mode: {"wall_ms": [], "gap_ms": 0.0} for mode in engines}
    for order in (list(engines), list(engines)[::-1]):
        for mode in order:
            eng = engines[mode]
            # one untimed step first: its dispatch gap would hold the
            # other modes' rounds
            eng.step()
            torch.cuda.synchronize()
            gap0 = eng.stats()["dispatch_gap_total_s"]
            t0 = time.perf_counter()
            for _ in range(ASYNC_TIMED // eng.substeps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[mode]["wall_ms"].append(1e3 * wall / ASYNC_TIMED)
            out[mode]["gap_ms"] += 1e3 * (eng.stats()["dispatch_gap_total_s"]
                                          - gap0) / (2 * ASYNC_TIMED)
    for mode, eng in engines.items():
        steps = ASYNC_PROFILED // eng.substeps
        out[mode]["busy_ms"] = _profiled(
            torch, f"async: {label} {mode}, {ASYNC_PROFILED} decode passes "
            "at 8 of 8 slots",
            lambda eng=eng: [eng.step() for _ in range(steps)]
        ) / ASYNC_PROFILED
    # the streams are left unfinished: the engines go with them
    return out


def _mode_runs(torch, model, econf, reqs, label, modes=ASYNC_MODES):
    """The same requests on a fresh engine in each mode, launches held
    exactly to each run's passes; the streams must be identical across the
    modes. Returns (streams, {mode: stats}, summed launches)."""
    from move2kube_tpu_torch.ops.attention import KERNELS

    streams, stats, launches = None, {}, dict.fromkeys(
        (k.name for k in KERNELS), 0)
    for mode, over in modes:
        t0 = time.perf_counter()
        eng, comps, got, wall = _engine_run(
            torch, model, dataclasses.replace(econf, **over), reqs(),
            f"{label} {mode}")
        for name, n in got.items():
            launches[name] += n
        mine = {rid: c.tokens for rid, c in comps.items()}
        if streams is None:
            streams = mine
        elif mine != streams:
            differ = sorted(r for r in mine if mine[r] != streams[r])
            raise RuntimeError(f"{label} {mode}: streams of {differ} differ "
                               f"from {modes[0][0]}'s")
        s = eng.stats()
        if eng._allocator.available != eng.cache_cfg.num_pages - 1:
            raise RuntimeError(f"{label} {mode}: pages still held")
        stats[mode] = s
        log(f"{label} {mode}: wall {wall:.3f} s for the 16 requests, "
            f"{s['passes']['decode']} decode passes in {s['decode_steps']} "
            f"steps, decode_time_s {s['decode_time_s']:.3f} (sync: dispatch "
            f"to read; async: consume to consume, admissions included), "
            f"dispatch gap {s['dispatch_gap_total_s']:.4f} s, "
            f"host_overhead_ratio {s['host_overhead_ratio']:.4f}; launches "
            f"{got}; {time.perf_counter() - t0:.1f} s ({CARD})")
        del eng, comps
    return streams, stats, launches


# the async phase and the fleet slice run on the slice's model cut to
# SERVE_LAYERS of its 32 layers, sharing their tensors, to hold the
# script inside its time limit on the slower hosts; the fleet router
# slice runs at full depth
SERVE_LAYERS = 8


def _cut_depth(model, layers: int):
    """A Llama on ``model``'s embedding, final norm, head and first
    ``layers`` blocks (the same tensors)."""
    from torch import nn

    from move2kube_tpu_torch import Llama

    cut = Llama(dataclasses.replace(model.cfg, num_layers=layers),
                device="meta")
    cut.embed, cut.final_norm = model.embed, model.final_norm
    cut.lm_head = model.lm_head
    cut.layers = nn.ModuleList(list(model.layers)[:layers])
    return cut


def async_phase(torch, model) -> dict:
    """The async decode pipeline on the card. Llama-8B's widths at
    SERVE_LAYERS layers (the serving slice's model cut, its requests,
    bf16, 8 x 2048 slots):
    synchronous, async N=1 and async N=4 with identical streams and
    launches exactly their passes; each mode's ms a decode pass at 8 of 8
    slots on the host's clock and in device busy time, and its dispatch
    gap with and without admissions;
    an EOS landing on an interior pass of a window stops every stream
    where the synchronous stream stops, and every page but the null page
    comes back; int8-kv at N=4 against the synchronous int8-kv run; GPT-2
    small synchronous against N=4. Returns the launches of the runs whose
    counts were checked."""
    from move2kube_tpu_torch import (
        EngineConfig,
        gpt2_small,
        init_gpt2,
        quantize_model,
    )

    t_phase = time.perf_counter()
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    reqs = _slice_requests(model.cfg.vocab_size)
    streams, stats, launches = _mode_runs(torch, model, econf, reqs,
                                          "async: llama_8b")
    log(f"async: llama_8b: the 16 streams are identical in the three modes "
        f"({sum(len(t) for t in streams.values())} tokens)")
    steady = _steady(torch, model, econf, "llama_8b", ASYNC_MODES)
    for mode, _ in ASYNC_MODES:
        s, st = stats[mode], steady[mode]
        log(f"async: llama_8b {mode}: at 8 of 8 slots, no admission: "
            f"{' and '.join(f'{w:.3f}' for w in st['wall_ms'])} ms a decode "
            f"pass (wall, two rounds), {st['busy_ms']:.3f} ms device busy, "
            f"dispatch gap {st['gap_ms']:.4f} ms a pass; with the admissions"
            f" of the 16 requests: gap {s['dispatch_gap_total_s']:.4f} s, "
            f"host_overhead_ratio {s['host_overhead_ratio']:.4f}; phase at "
            f"{time.perf_counter() - t_phase:.1f} s ({CARD})")

    # EOS on an interior pass of a 4-pass window: token k of a stream
    # comes from pass (k - 1) % 4 of its window
    first = streams["r0"]
    k = next(k for k in range(1, len(first)) if (k - 1) % 4 in (1, 2)
             and first[k] not in first[:k])
    eos = first[k]
    want = {rid: (t[:t.index(eos) + 1] if eos in t else t)
            for rid, t in streams.items()}
    eng, comps, got, _ = _engine_run(
        torch, model, dataclasses.replace(econf, eos_id=eos,
                                          **ASYNC_MODES[2][1]),
        reqs(), "async: llama_8b N=4 eos")
    for name, n in got.items():
        launches[name] += n
    mine = {rid: c.tokens for rid, c in comps.items()}
    if mine != want or comps["r0"].finish_reason != "eos":
        raise RuntimeError(f"async: eos {eos}: the N=4 streams do not stop "
                           "where the synchronous streams do")
    if eng._allocator.available != eng.cache_cfg.num_pages - 1:
        raise RuntimeError("async: eos: pages still held after the run")
    stopped = sum(c.finish_reason == "eos" for c in comps.values())
    log(f"async: eos {eos} at token {k} of r0 (pass {(k - 1) % 4} of its "
        f"window): {stopped} of 16 streams stop at it, each where the "
        f"synchronous stream does; every page but the null page is free; "
        f"phase at {time.perf_counter() - t_phase:.1f} s")
    del eng, comps

    # int8-kv: the paged_decode_int8 path, synchronous against N=4
    qmodel = quantize_model(model)
    streams8, _, got = _mode_runs(
        torch, qmodel, dataclasses.replace(econf, quant="int8-kv"), reqs,
        "async: llama_8b int8-kv", (ASYNC_MODES[0], ASYNC_MODES[2]))
    for name, n in got.items():
        launches[name] += n
    same = sum(a == b for r in streams
               for a, b in zip(streams[r], streams8[r]))
    log(f"async: llama_8b int8-kv: the 16 streams are identical at N=4 and "
        f"in the synchronous loop; {same} of "
        f"{sum(len(t) for t in streams.values())} tokens equal the bf16 "
        "streams'")
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()

    # GPT-2 small: synchronous against N=4
    g = init_gpt2(gpt2_small(), seed=SEED, device="cuda").eval()
    gconf = EngineConfig(max_batch=8, max_seq=1024, block_size=16)
    _, gstats, got = _mode_runs(
        torch, g, gconf, _slice_requests(g.cfg.vocab_size, 768),
        "async: gpt2_small", (ASYNC_MODES[0], ASYNC_MODES[2]))
    for name, n in got.items():
        launches[name] += n
    steady = _steady(torch, g, gconf, "gpt2_small",
                     (ASYNC_MODES[0], ASYNC_MODES[2]))
    for mode, st in steady.items():
        log(f"async: gpt2_small {mode}: at 8 of 8 slots "
            f"{' and '.join(f'{w:.3f}' for w in st['wall_ms'])} ms a decode "
            f"pass (wall, two rounds), {st['busy_ms']:.3f} ms busy, gap "
            f"{st['gap_ms']:.4f} ms a pass; host_overhead_ratio over the 16 "
            f"requests {gstats[mode]['host_overhead_ratio']:.4f}; phase at "
            f"{time.perf_counter() - t_phase:.1f} s ({CARD})")
    del g
    gc.collect()
    torch.cuda.empty_cache()
    log(f"async: phase {time.perf_counter() - t_phase:.1f} s ({CARD})")
    return launches


def _greedy_prefix(a, b) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def fleet_parity_phase(torch) -> None:
    """The fleet replica's engine paths at Llama-8B width, 2 layers, fp32,
    the attention in the kernels, against the plain engine from the same
    weights: (a) the prefix cache (a cold prompt of 300 tokens, its rerun,
    a fork of its first 296 tokens plus 6 new), streams identical to a
    cache-off engine's and every logit row within FP32_ENGINE_ATOL, with
    COW copies and two hits; (b) spec decode (k=3, a 1-layer draft) on 4
    requests admitted together, streams identical, and again with the
    prefix cache on hits whose suffixes (12 and 7 tokens) outrun the
    verify window, streams identical to the plain engine's; (c) chunked
    prefill of a 300-token prompt in chunks of 64 while 3 short prompts
    decode, every logit row of the chunked prompt within FP32_ENGINE_ATOL
    of the unchunked run's and all 4 streams identical; (d) int8-kv with the prefix cache against
    the int8-kv cache-off engine, within QUANT_GATE_REL. Every run's
    launch counts are checked exactly against the engine's passes."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        init_llama,
        llama_8b,
        logit_gate,
    )

    cfg = dataclasses.replace(llama_8b(), num_layers=2, dtype=torch.float32,
                              attn_impl="flash")
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    rng = np.random.default_rng(SEED + 9)
    base = dict(max_batch=4, max_seq=640, block_size=16)

    def copies(reqs):
        return [Request(r.rid, list(r.prompt), r.max_new_tokens)
                for r in reqs]

    # (a) prefix cache
    shared = rng.integers(1, cfg.vocab_size, size=300).tolist()
    fork = shared[:296] + rng.integers(1, cfg.vocab_size, size=6).tolist()
    pre = [Request("cold", list(shared), 8), Request("rerun", list(shared), 8),
           Request("fork", fork, 8)]
    hit_eng, got, _, _ = _engine_run(
        torch, model, EngineConfig(**base, prefix_cache=True), copies(pre),
        "fleet parity prefix")
    off_eng, want, _, _ = _engine_run(torch, model, EngineConfig(**base),
                                      copies(pre), "fleet parity prefix off")
    stats = hit_eng.stats()
    worst = 0.0
    for r in pre:
        if got[r.rid].tokens != want[r.rid].tokens:
            raise RuntimeError(f"fleet parity prefix: {r.rid} stream "
                               f"{got[r.rid].tokens} != cache-off "
                               f"{want[r.rid].tokens}")
        for a, b in zip(hit_eng.logit_log[r.rid], off_eng.logit_log[r.rid]):
            worst = max(worst, float(np.abs(a - b).max()))
    if not (worst <= FP32_ENGINE_ATOL and stats["prefix_hits"] == 2
            and stats["cow_copies"] >= 1):
        raise RuntimeError(f"fleet parity prefix: logits max abs err {worst}"
                           f" (tol {FP32_ENGINE_ATOL}), prefix_hits "
                           f"{stats['prefix_hits']} (want 2), cow_copies "
                           f"{stats['cow_copies']}")
    log(f"fleet parity (a) prefix cache: llama_8b widths, 2 layers, fp32; "
        f"cold 300 tokens, rerun, fork 296+6, 8 new tokens each: streams "
        f"identical to the cache-off engine, logits max abs err {worst:.3e} "
        f"(tol {FP32_ENGINE_ATOL}); prefix_hits {stats['prefix_hits']}, "
        f"hit tokens {stats['prefix_hit_tokens']}, cow_copies "
        f"{stats['cow_copies']}")
    del hit_eng, off_eng

    # (b) spec decode
    spec_reqs = [Request(f"s{i}", rng.integers(
        1, cfg.vocab_size, size=int(n)).tolist(), 16)
        for i, n in enumerate((37, 150, 300, 97))]
    spec_conf = EngineConfig(**base, admit_burst=0, spec_k=3,
                             spec_draft_factor=2)
    spec_eng, got, _, _ = _engine_run(torch, model, spec_conf,
                                      copies(spec_reqs), "fleet parity spec")
    _, want, _, _ = _engine_run(torch, model, EngineConfig(
        **base, admit_burst=0), copies(spec_reqs), "fleet parity spec off")
    for r in spec_reqs:
        if got[r.rid].tokens != want[r.rid].tokens:
            raise RuntimeError(f"fleet parity spec: {r.rid} stream "
                               f"{got[r.rid].tokens} != plain "
                               f"{want[r.rid].tokens}")
    stats = spec_eng.stats()
    del spec_eng
    # spec with the prefix cache: hits whose suffixes (12 tokens past 18
    # full pages; 7 past the whole prompt, its boundary page COW-copied)
    # outrun the verify window of k + 1, so each is fed over fully forced
    # windows, against the plain (cache-off, spec-off) engine
    tail = rng.integers(1, cfg.vocab_size, size=12).tolist()
    sp_reqs = [Request("cold", list(shared), 8),
               Request("fork", shared[:288] + tail, 8),
               Request("fork2", shared + tail[:7], 8)]
    sp_eng, got, _, _ = _engine_run(
        torch, model, dataclasses.replace(spec_conf, prefix_cache=True),
        copies(sp_reqs), "fleet parity spec + prefix")
    _, want, _, _ = _engine_run(torch, model, EngineConfig(**base),
                                copies(sp_reqs), "fleet parity spec + "
                                "prefix off")
    sp = sp_eng.stats()
    if (any(got[r.rid].tokens != want[r.rid].tokens for r in sp_reqs)
            or sp["prefix_hits"] != 2):
        raise RuntimeError(
            f"fleet parity spec + prefix: streams "
            f"{[got[r.rid].tokens for r in sp_reqs]} vs plain "
            f"{[want[r.rid].tokens for r in sp_reqs]}, prefix_hits "
            f"{sp['prefix_hits']} (want 2)")
    log(f"fleet parity (b) spec decode k=3, 1-layer draft, 4 requests "
        f"admitted together, 16 new tokens each: streams identical to the "
        f"plain engine; acceptance {stats['spec_acceptance_rate']:.3f}, "
        f"{stats['spec_tokens_per_step']:.2f} tokens a step, passes "
        f"{stats['passes']}; with the prefix cache, hits with suffixes of "
        f"12 and 7 tokens (covered {sp['prefix_hit_tokens']} tokens): "
        f"streams identical to the plain engine")
    del sp_eng

    # (c) chunked prefill: the long prompt's stream and every logit row
    # of it are held too
    long_p = rng.integers(1, cfg.vocab_size, size=300).tolist()
    chunk_reqs = [Request(f"c{i}", rng.integers(
        1, cfg.vocab_size, size=int(n)).tolist(), 16)
        for i, n in enumerate((23, 64, 41))] + [Request("long", long_p, 4)]
    ch_eng, got, _, _ = _engine_run(
        torch, model, EngineConfig(**base, admit_burst=0, chunk_prefill=64),
        copies(chunk_reqs), "fleet parity chunked")
    whole_eng, want, _, _ = _engine_run(
        torch, model, EngineConfig(**base, admit_burst=0),
        copies(chunk_reqs), "fleet parity chunked off")
    # the final chunk's row, then every decode step after the chunk (the
    # seq_lens handed over, the chunk's pages past its first row)
    first = float(np.abs(ch_eng.logit_log["long"][0]
                         - whole_eng.logit_log["long"][0]).max())
    err = max(float(np.abs(a - b).max()) for a, b in zip(
        ch_eng.logit_log["long"], whole_eng.logit_log["long"]))
    rows = len(ch_eng.logit_log["long"])
    stats = ch_eng.stats()
    if any(got[r.rid].tokens != want[r.rid].tokens for r in chunk_reqs) \
            or err > FP32_ENGINE_ATOL or stats["chunked_prefills"] != 1 \
            or rows != len(whole_eng.logit_log["long"]) or rows != 4:
        raise RuntimeError(
            f"fleet parity chunked: the chunked prompt's {rows} logit rows "
            f"max abs err {err} (tol {FP32_ENGINE_ATOL}), chunked_prefills "
            f"{stats['chunked_prefills']}, streams "
            f"{[got[r.rid].tokens for r in chunk_reqs]} vs "
            f"{[want[r.rid].tokens for r in chunk_reqs]}")
    log(f"fleet parity (c) chunked prefill of 300 tokens in chunks of 64 "
        f"beside 3 running prompts (23, 64, 41 tokens): final-chunk logits "
        f"max abs err {first:.3e} against the whole prefill, all {rows} of "
        f"the chunked prompt's rows {err:.3e} (tol {FP32_ENGINE_ATOL}); "
        f"all 4 streams identical; {stats['passes']['chunk']} chunk passes")
    del ch_eng, whole_eng

    # (d) int8-kv with the prefix cache
    q_hit, got, q_launch, _ = _engine_run(
        torch, model, EngineConfig(**base, prefix_cache=True,
                                   quant="int8-kv"),
        copies(pre), "fleet parity int8-kv prefix")
    q_off, want, _, _ = _engine_run(
        torch, model, EngineConfig(**base, quant="int8-kv"), copies(pre),
        "fleet parity int8-kv prefix off")
    worst, rows = 0.0, 0
    for rid in ("rerun", "fork"):
        agree = _greedy_prefix(got[rid].tokens, want[rid].tokens)
        for i in range(min(agree + 1, len(q_hit.logit_log[rid]))):
            worst = max(worst, logit_gate(q_off.logit_log[rid][i],
                                          q_hit.logit_log[rid][i])
                        ["max_rel_err"])
            rows += 1
    if not (worst < QUANT_GATE_REL and rows >= 2
            and q_launch["paged_decode_int8"] > 0
            and q_hit.stats()["prefix_hits"] == 2):
        raise RuntimeError(f"fleet parity int8-kv prefix: max rel err "
                           f"{worst:.4f} over {rows} rows (tol "
                           f"{QUANT_GATE_REL}), launches {q_launch}, hits "
                           f"{q_hit.stats()['prefix_hits']}")
    log(f"fleet parity (d) int8-kv with the prefix cache: rerun and fork "
        f"against the int8-kv cache-off engine, max rel logit err "
        f"{worst:.4f} over {rows} rows (tol {QUANT_GATE_REL}); "
        f"paged_decode_int8 launched {q_launch['paged_decode_int8']} times")
    del q_hit, q_off, model
    torch.cuda.empty_cache()


def _pctl(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, float), q)) * 1e3


def _ttfts(tracer):
    """Per-request TTFT and queue wait (seconds) from the engine's spans:
    the root's ``ttft_s`` and its ``serve.queue_wait`` child."""
    spans = tracer.snapshot()
    roots = {s["span_id"]: s for s in spans if s["name"] == "serve.request"}
    out = {r["attrs"]["rid"]: {"ttft": r["attrs"].get("ttft_s")}
           for r in roots.values()}
    for s in spans:
        if s["name"] == "serve.queue_wait" and s["parent_id"] in roots:
            out[roots[s["parent_id"]]["attrs"]["rid"]]["queue"] = s["dur_s"]
    return out


def fleet_slice_phase(torch, model) -> dict:
    """The fleet replica's engine at full width: Llama-8B's widths (the
    serving slice's model cut to SERVE_LAYERS layers), bf16, flash,
    ``EngineConfig(max_batch=8, max_seq=2048, block_size=16)``, seed-0
    weights (``model``). Three runs, each on a fresh engine after a
    warm-up, each with its launch counts checked exactly against the
    engine's passes: prefix traffic (16 requests on a shared 1000-token
    system prompt, 15 hits), spec decode (k=4, a draft of half the
    target's layers sharing its tensors, streams identical to the plain
    engine's) and
    chunked prefill (a 256-token prompt in 4 chunks beside 7 running
    streams, identical to the run without chunking; the chunked prompt's
    logits within ROUTE_GATE_REL of its whole prefill's). Returns the
    paged kernel's launch count over the three runs."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        logit_gate,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.obs.tracing import SpanRecorder
    from move2kube_tpu_torch.ops.attention import KERNELS

    cfg = model.cfg
    vocab = cfg.vocab_size
    base = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    paged_total = 0

    def warm(econf, prompts):
        ServingEngine(model, econf, device="cuda").run(
            [Request(f"w{i}", list(p), 4) for i, p in enumerate(prompts)])
        torch.cuda.synchronize()

    # 1. prefix traffic
    rng = np.random.default_rng(3)
    system = rng.integers(1, vocab, size=1000).tolist()
    tails = [rng.integers(1, vocab, size=int(n)).tolist()
             for n in rng.integers(1, 25, size=14)]
    first = system + tails[0]
    prompts = [first, list(first), list(first)] + [system + t
                                                    for t in tails[1:]]
    order = [0, 3, 1, 4, 5, 6, 7, 2] + list(range(8, 16))
    reqs = [Request(f"p{i}", prompts[i], 64) for i in order]
    pconf = dataclasses.replace(base, prefix_cache=True)
    warm(pconf, [system[:40] + [1], system[:40] + [2]])
    torch.cuda.reset_peak_memory_stats()
    tracer = SpanRecorder()
    eng, comps, launches, wall = _engine_run(torch, model, pconf, reqs,
                                             "fleet slice prefix", tracer)
    stats = eng.stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for rid, rows in eng.logit_log.items():
        if not all(np.isfinite(r).all() for r in rows):
            raise RuntimeError(f"fleet slice prefix: non-finite logits "
                               f"for {rid}")
    if (stats["prefix_hits"] != 15 or stats["cow_copies"] < 1
            or any(len(c.tokens) != 64 for c in comps.values())):
        raise RuntimeError(f"fleet slice prefix: hits {stats['prefix_hits']}"
                           f" (want 15), cow_copies {stats['cow_copies']}, "
                           f"tokens {[len(c.tokens) for c in comps.values()]}")
    times = _ttfts(tracer)
    cold = [times["p0"]]
    hits = [t for rid, t in times.items() if rid != "p0"]

    def summary(ts):
        ttft = [t["ttft"] for t in ts]
        served = [t["ttft"] - t.get("queue", 0.0) for t in ts]
        return (f"TTFT p50 {_pctl(ttft, 50):.1f} p95 {_pctl(ttft, 95):.1f} "
                f"ms, less queue wait p50 {_pctl(served, 50):.1f} p95 "
                f"{_pctl(served, 95):.1f} ms")

    t_render = time.perf_counter()
    text = eng.registry.render()
    render_ms = (time.perf_counter() - t_render) * 1e3
    log(f"fleet slice prefix: llama_8b bf16, 16 requests on a 1000-token "
        f"system prompt with tails of {sorted(len(t) for t in tails)} tokens"
        f" (2 repeat the first), 64 new tokens each, max_batch 8: wall "
        f"{wall:.3f} s; cold (1): {summary(cold)}; hits "
        f"({stats['prefix_hits']}): {summary(hits)}; hit rate "
        f"{stats['prefix_hit_rate']:.4f}, hit tokens "
        f"{stats['prefix_hit_tokens']}, prefix pages "
        f"{stats['prefix_cache_pages']}, cow_copies {stats['cow_copies']}; "
        f"decode {stats['decode_time_s'] / stats['decode_steps'] * 1e3:.2f} "
        f"ms/step over {stats['decode_steps']} steps; peak memory "
        f"{peak:.2f} GiB; launches {launches}; one /metrics render "
        f"{len(text)} bytes, {len(text.splitlines())} lines, "
        f"{render_ms:.3f} ms of host time")
    paged_total += launches["paged_decode"]
    del eng, tracer

    # 2. spec decode
    rng = np.random.default_rng(4)
    reqs = [Request(f"s{i}", rng.integers(1, vocab, size=int(n)).tolist(),
                    32) for i, n in enumerate(rng.integers(64, 513, size=8))]
    plain_conf = dataclasses.replace(base, admit_burst=0)
    sconf = dataclasses.replace(plain_conf, spec_k=4, spec_draft_factor=2)
    warm(sconf, [list(range(1, 65)), list(range(2, 70))])
    warm(plain_conf, [list(range(1, 65))])

    def copies():
        return [Request(r.rid, list(r.prompt), r.max_new_tokens)
                for r in reqs]

    s_eng, got, s_launch, s_wall = _engine_run(torch, model, sconf, copies(),
                                               "fleet slice spec")
    p_eng, want, p_launch, p_wall = _engine_run(torch, model, plain_conf,
                                                copies(), "fleet slice plain")
    diff = [r.rid for r in reqs if got[r.rid].tokens != want[r.rid].tokens]
    if diff:
        r = diff[0]
        raise RuntimeError(
            f"fleet slice spec: streams of {diff} differ from plain bf16; "
            f"{r}: first difference at token "
            f"{_greedy_prefix(got[r].tokens, want[r].tokens)}")
    st, pt = s_eng.stats(), p_eng.stats()
    k = sconf.spec_k
    if st["passes"]["verify"] != (k + 1) * st["decode_steps"] or (
            st["passes"]["draft_decode"] != (k + 1) * st["decode_steps"]):
        raise RuntimeError(f"fleet slice spec: passes {st['passes']} for "
                           f"{st['decode_steps']} spec steps")
    log(f"fleet slice spec: k={k}, a {cfg.num_layers // 2}-layer draft "
        f"sharing the target's tensors, 8 requests of "
        f"{sorted(len(r.prompt) for r in reqs)} tokens admitted together, "
        f"32 new tokens each: streams identical to the plain bf16 engine; "
        f"acceptance {st['spec_acceptance_rate']:.4f} "
        f"({st['spec_accepted']} of {st['spec_proposed']}), "
        f"{st['spec_tokens_per_step']:.3f} tokens a step over "
        f"{st['decode_steps']} spec steps, "
        f"{st['decode_time_s'] / st['decode_steps'] * 1e3:.2f} ms a spec "
        f"step, wall {s_wall:.3f} s; plain engine "
        f"{pt['decode_time_s'] / pt['decode_steps'] * 1e3:.2f} ms/step over "
        f"{pt['decode_steps']} steps ({pt['decode_tokens'] / pt['decode_steps']:.3f}"
        f" tokens a step), wall {p_wall:.3f} s; launches spec {s_launch}, "
        f"plain {p_launch}")
    paged_total += s_launch["paged_decode"] + p_launch["paged_decode"]
    del s_eng, p_eng
    # where a spec step's time goes: the second step of a fresh engine
    # (the first admits the 8 prompts), 8 of 8 slots
    eng = ServingEngine(model, sconf, device="cuda")
    for r in copies():
        eng.submit(r)
    eng.step()
    passes = (k + 1) * (cfg.num_layers + cfg.num_layers // 2)
    _profiled(torch, f"one spec step (k={k}: {k + 1} draft passes of "
              f"{cfg.num_layers // 2} layers, {k + 1} verify passes of "
              f"{cfg.num_layers}; {passes} layer passes) at 8 of 8 slots",
              eng.step)
    del eng
    torch.cuda.empty_cache()

    # 3. chunked prefill
    rng = np.random.default_rng(5)
    short = [rng.integers(1, vocab, size=int(n)).tolist()
             for n in rng.integers(32, 65, size=7)]
    long_p = rng.integers(1, vocab, size=256).tolist()
    reqs = ([Request(f"c{i}", p, 64) for i, p in enumerate(short)]
            + [Request("long", long_p, 64)])
    cconf = dataclasses.replace(base, admit_burst=0, chunk_prefill=64)
    warm(cconf, [list(range(1, 33)), list(range(1, 130))])
    eng = ServingEngine(model, cconf, device="cuda")
    eng.capture_logits = True
    for r in reqs:
        eng.submit(Request(r.rid, list(r.prompt), r.max_new_tokens))
    reset_launch_counts()
    during, outside, got = [], [], {}
    t_all = time.perf_counter()
    while eng.has_work():
        chunks = eng.stats()["passes"]["chunk"]
        t0 = time.perf_counter()
        for c in eng.step():
            got[c.rid] = c.tokens
        dt = time.perf_counter() - t0
        (during if eng.stats()["passes"]["chunk"] > chunks
         else outside).append(dt)
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t_all
    c_launch = {k_.name: k_.launches for k_ in KERNELS}
    cs = eng.stats()
    exp = _expected_launches(cs, cfg.num_layers, 0)
    if c_launch != {"flash_fwd": exp["flash_fwd"], "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0, "paged_decode": exp["paged"],
                    "paged_decode_int8": 0} or cs["passes"]["chunk"] != 256:
        raise RuntimeError(f"fleet slice chunked: launches {c_launch}, "
                           f"passes {cs['passes']}")
    off_eng, want, w_launch, _ = _engine_run(
        torch, model, dataclasses.replace(base, admit_burst=0),
        [Request(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs],
        "fleet slice chunked off")
    diff = [r.rid for r in reqs[:7] if got[r.rid] != want[r.rid].tokens]
    if diff or len(got) != 8:
        raise RuntimeError(f"fleet slice chunked: the running streams of "
                           f"{diff} differ from the run without chunking")
    # the chunked prompt against the run without chunking (its whole
    # prefill): every logit row up to the first token where the streams
    # part, within ROUTE_GATE_REL
    rows_c, rows_w = eng.logit_log["long"], off_eng.logit_log["long"]
    agree = _greedy_prefix(got["long"], want["long"].tokens)
    gated = min(agree + 1, len(rows_c), len(rows_w))
    gate = [logit_gate(rows_w[i], rows_c[i]) for i in range(gated)]
    err = gate[0]["max_abs_err"]
    rel = max(g["max_rel_err"] for g in gate)
    if not rel < ROUTE_GATE_REL:
        raise RuntimeError(
            f"fleet slice chunked: the chunked prompt's logits against the "
            f"whole prefill's: max rel err {rel:.4f} over {gated} rows (tol "
            f"{ROUTE_GATE_REL}), first row max abs err {err:.4e}")
    log(f"fleet slice chunked: 7 requests of {sorted(len(p) for p in short)}"
        f" tokens decoding 64 tokens while a 256-token prompt is chunked in "
        f"{len(during)} chunks of 64: running streams identical to the run "
        f"without chunking; chunk job {sum(during):.3f} s of wall time in "
        f"total ({cs['passes']['chunk']} single-token passes, "
        f"{sum(during) / cs['passes']['chunk'] * 1e3:.2f} ms a pass); steps "
        f"with a chunk {np.mean(during) * 1e3:.1f} ms, without "
        f"{np.mean(outside) * 1e3:.1f} ms ({len(outside)} steps); "
        f"the chunked prompt against its whole prefill: final-chunk logits "
        f"max abs err {err:.4e}, max rel err {rel:.4f} over {gated} rows "
        f"(its stream agrees for {agree} of 64 tokens; bf16, tol "
        f"{ROUTE_GATE_REL}); wall {c_wall:.3f} s; launches {c_launch}, "
        f"without chunking {w_launch}")
    paged_total += c_launch["paged_decode"]
    del eng, off_eng
    # where a chunk step's time goes: the second step of a fresh engine
    # whose long prompt is cut to 68 tokens, so that step is a decode step
    # of the 7 running rows and the final chunk's 4 passes (a whole chunk
    # of 64 is some 150,000 kernels, too many to profile in the budget)
    eng = ServingEngine(model, cconf, device="cuda")
    for r in reqs:
        eng.submit(Request(r.rid, list(r.prompt[:68]), r.max_new_tokens))
    eng.step()
    _profiled(torch, "one chunk step (a decode step of 7 rows + the final "
              "chunk's 4 single-token passes of a 68-token prompt)",
              eng.step)
    del eng
    torch.cuda.empty_cache()
    return paged_total


# ----------------------------------------------------------------------
# the fleet: scheduler plane, multi-LoRA, live swap, disagg, router
# ----------------------------------------------------------------------

FLEET_SPEC = "gold:prio=high;bronze:prio=besteffort"
FLEET_WAIT_S = 600.0  # bound on every wait for a client or replica thread


def _launch_counts():
    from move2kube_tpu_torch.ops.attention import KERNELS

    return {k.name: k.launches for k in KERNELS}


def _want_launches(parts, paged="paged_decode") -> dict:
    """The exact launch counts of a run, from ``(stats, layers,
    draft_layers)`` of every engine (or prefill replica) in it."""
    from move2kube_tpu_torch.ops.attention import KERNELS

    want = {k.name: 0 for k in KERNELS}
    for stats, layers, draft_layers in parts:
        exp = _expected_launches(stats, layers, draft_layers)
        want["flash_fwd"] += exp["flash_fwd"]
        want[paged] += exp["paged"]
    return want


def _check_launches(label, got, want) -> None:
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want} from "
                           "the passes")


def _client(router, results, errors, rid, prompt, n, **kw):
    """A thread that sends one request through ``router.generate``."""
    import threading

    def run():
        t0 = time.perf_counter()
        try:
            out = router.generate(list(prompt), n, rid=rid, **kw)
            out["t_start"], out["t_end"] = t0, time.perf_counter()
            results[rid] = out
        except Exception as err:  # noqa: BLE001 - reported by the caller
            errors.append(f"{rid}: {type(err).__name__}: {err}")

    t = threading.Thread(target=run, name=f"client-{rid}", daemon=True)
    t.start()
    return t


def _join(threads, label) -> None:
    t_end = time.perf_counter() + FLEET_WAIT_S
    for t in threads:
        t.join(timeout=max(0.0, t_end - time.perf_counter()))
        if t.is_alive():
            raise RuntimeError(f"{label}: {t.name} did not finish in "
                               f"{FLEET_WAIT_S:.0f} s")


def _wait_for(cond, label) -> None:
    t_end = time.perf_counter() + FLEET_WAIT_S
    while not cond():
        if time.perf_counter() > t_end:
            raise RuntimeError(f"timed out waiting for {label}")
        time.sleep(0.001)


def fleet_router_parity_phase(torch) -> None:
    """The fleet paths at Llama-8B width, 2 layers, fp32, the attention in
    the kernels, each against the plain engine from the same weights, each
    run's launch counts exact: (a) a best-effort stream preempted by a
    gold request on a one-slot replica driven by hand (its worker thread
    not started), resumed by the router from its journal, its stream
    equal to the uninterrupted one and its logits within FP32_ENGINE_ATOL;
    (b) a batch of the base model and two adapters, each stream equal to
    its single-adapter run; (c) a prefill replica's handoffs over the wire
    bytes installed in a decode engine, streams equal to the cold
    engine's and logits within FP32_ENGINE_ATOL; (d) a same-weights swap
    mid-decode on a prefix-cache engine: streams and every logit row
    bit-equal to the unswapped run, the new version on the Completions,
    the prefix cache flushed."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_8b,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.serving.fleet.disagg import (
        KVHandoff,
        PrefillReplica,
    )
    from move2kube_tpu_torch.serving.fleet.router import (
        InProcessReplica,
        Router,
        RouterConfig,
    )

    cfg = dataclasses.replace(llama_8b(), num_layers=2, dtype=torch.float32,
                              attn_impl="flash")
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    layers, vocab = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(SEED + 10)
    base = dict(max_batch=4, max_seq=640, block_size=16)

    def rows_err(a, b):
        if len(a) != len(b):
            raise RuntimeError(f"fleet router parity: {len(a)} logit rows "
                               f"against {len(b)}")
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    # (a) preemption and the router's resume
    p_be = rng.integers(1, vocab, size=200).tolist()
    p_gold = rng.integers(1, vocab, size=100).tolist()
    one = dict(base, max_batch=1)
    plain = ServingEngine(model, EngineConfig(**one), device="cuda")
    plain.capture_logits = True
    want = plain.run([Request("be", list(p_be), 12)])[0].tokens
    eng = ServingEngine(model, EngineConfig(**one, sched_tenants=FLEET_SPEC),
                        device="cuda")
    eng.capture_logits = True
    rep = InProcessReplica("replica-0", eng)
    rep.start = lambda: rep  # no worker thread: this phase steps the engine
    router = Router([rep], RouterConfig(sched_tenants=FLEET_SPEC,
                                        deadline_s=FLEET_WAIT_S))
    results, errors = {}, []
    reset_launch_counts()
    threads = [_client(router, results, errors, "be", p_be, 12,
                       tenant="bronze")]
    _wait_for(lambda: any(r.rid == "be" for r in eng._pending),
              "the best-effort submit")
    for _ in range(4):
        rep._step_once()
    threads.append(_client(router, results, errors, "gold", p_gold, 3,
                           tenant="gold"))
    _wait_for(lambda: any(r.rid == "gold" for r in eng._pending),
              "the gold submit")
    rep._step_once()  # admits gold: the best-effort stream is preempted
    t_end = time.perf_counter() + FLEET_WAIT_S
    while any(t.is_alive() for t in threads):
        if time.perf_counter() > t_end:
            raise RuntimeError("fleet router parity (a): streams did not "
                               "finish")
        if not rep._step_once():
            time.sleep(0.001)
    _join(threads, "fleet router parity (a)")
    st = eng.stats()
    _check_launches("fleet router parity (a)", _launch_counts(),
                    _want_launches([(st, layers, 0)]))
    err = rows_err(eng.logit_log["be"], plain.logit_log["be"])
    if (errors or results["be"]["tokens"] != want
            or not results["be"].get("resumed") or st["preempted"] != 1
            or router._sched_resumed.labels(reason="preempted").value != 1
            or err > FP32_ENGINE_ATOL):
        raise RuntimeError(
            f"fleet router parity (a): errors {errors}, resumed stream "
            f"{results.get('be')} vs uninterrupted {want}, preempted "
            f"{st['preempted']}, logits max abs err {err}")
    log(f"fleet router parity (a) preemption: llama_8b widths, 2 layers, "
        f"fp32, one slot driven by hand; a best-effort stream (200-token "
        f"prompt, 12 new) preempted after 5 tokens by a gold request, "
        f"resumed by the router from its journal: stream identical to the "
        f"uninterrupted one, its 12 logit rows max abs err {err:.3e} (tol "
        f"{FP32_ENGINE_ATOL}); passes {st['passes']}")
    del eng, plain, rep, router

    # (b) a mixed LoRA batch
    adapters = {}
    for name, r in (("fin", 8), ("law", 4)):
        adapters[name] = (
            (rng.normal(size=(cfg.d_model, r)) * 0.05).astype(np.float32),
            (rng.normal(size=(r, vocab)) * 0.05).astype(np.float32))
    lconf = EngineConfig(**base, max_loras=2, lora_rank=8, admit_burst=0)
    mix = ["", "fin", "law", "fin"]
    prompts = [rng.integers(1, vocab, size=n).tolist()
               for n in (37, 150, 90, 300)]

    def lora_run(names, idx):
        e = ServingEngine(model, lconf if any(names) else EngineConfig(
            **base, admit_burst=0), device="cuda")
        for name in sorted(set(n for n in names if n)):
            e.register_adapter(name, *adapters[name])
        e.capture_logits = True
        reset_launch_counts()
        done = {c.rid: c.tokens for c in e.run(
            [Request(f"r{i}", list(prompts[i]), 8, adapter=names[j])
             for j, i in enumerate(idx)])}
        _check_launches("fleet router parity (b)", _launch_counts(),
                        _want_launches([(e.stats(), layers, 0)]))
        return done, e.logit_log

    got, got_log = lora_run(mix, range(4))
    worst, differ = 0.0, 0
    for i, name in enumerate(mix):
        alone, alone_log = lora_run([name], [i])
        if got[f"r{i}"] != alone[f"r{i}"]:
            raise RuntimeError(f"fleet router parity (b): r{i} ({name!r}) "
                               f"{got[f'r{i}']} != its single-adapter run "
                               f"{alone[f'r{i}']}")
        worst = max(worst, rows_err(got_log[f"r{i}"], alone_log[f"r{i}"]))
        if name:
            base_run, _ = lora_run([""], [i])
            differ += base_run[f"r{i}"] != got[f"r{i}"]
    if worst > FP32_ENGINE_ATOL or not differ:
        raise RuntimeError(f"fleet router parity (b): logits max abs err "
                           f"{worst}, adapter streams unlike the base "
                           f"model's: {differ}")
    log(f"fleet router parity (b) multi-LoRA: base + adapters of rank 8 and "
        f"4 (A/B at 0.05 scale) on 4 requests in one batch, 8 new tokens: "
        f"every stream identical to its single-adapter run, logits max abs "
        f"err {worst:.3e} (tol {FP32_ENGINE_ATOL}); {differ} of 3 adapter "
        f"streams differ from the base model's")

    # (c) disagg over the wire bytes
    dconf = EngineConfig(**base)
    reqs = [Request(f"d{i}", rng.integers(1, vocab, size=n).tolist(), 8)
            for i, n in enumerate((300, 520))]
    pre = PrefillReplica(model, dconf, device="cuda")
    eng = ServingEngine(model, dconf, device="cuda")
    eng.capture_logits = True
    reset_launch_counts()
    wire = [pre.prefill(r).to_bytes() for r in reqs]
    got, inbox = {}, [KVHandoff.from_bytes(b) for b in wire]
    while inbox or eng.has_work():
        while inbox:
            h = inbox[0]
            ok, done = eng.install_prefilled(h.request(), h.kv,
                                             h.first_token, h.prompt_len)
            got.update({c.rid: c.tokens for c in done})
            if not ok:
                break
            inbox.pop(0)
        got.update({c.rid: c.tokens for c in eng.step()})
    _check_launches("fleet router parity (c)", _launch_counts(),
                    _want_launches([(eng.stats(), layers, 0),
                                    (pre.stats(), layers, 0)]))
    cold, want, _, _ = _engine_run(
        torch, model, dconf, [Request(r.rid, list(r.prompt), 8)
                              for r in reqs], "fleet router parity (c) cold")
    err = max(rows_err(eng.logit_log[r.rid], cold.logit_log[r.rid][1:])
              for r in reqs)
    if any(got[r.rid] != want[r.rid].tokens for r in reqs) or (
            err > FP32_ENGINE_ATOL):
        raise RuntimeError(f"fleet router parity (c): streams {got} vs cold "
                           f"{ {r: c.tokens for r, c in want.items()} }, "
                           f"logits max abs err {err}")
    log(f"fleet router parity (c) disagg: prompts of 300 and 520 tokens "
        f"prefilled on a prefill replica, {sum(map(len, wire))} wire bytes "
        f"(fp32), installed and decoded 8 tokens: streams identical to the "
        f"cold engine's, decode logits max abs err {err:.3e} (tol "
        f"{FP32_ENGINE_ATOL})")
    del eng, cold, pre

    # (d) a same-weights swap mid-decode
    shared = rng.integers(1, vocab, size=160).tolist()
    tail = rng.integers(1, vocab, size=9).tolist()
    other = rng.integers(1, vocab, size=70).tolist()
    sconf = EngineConfig(**base, prefix_cache=True)

    def swap_run(swap):
        e = ServingEngine(model, sconf, device="cuda")
        e.capture_logits = True
        reset_launch_counts()
        e.run([Request("warm", list(shared), 4)])
        e.submit(Request("s", shared[:144] + tail, 12))
        e.submit(Request("t", list(other), 12))
        done, pages, swapped, old = [], e._prefix.total_pages, False, set()
        while e.has_work():
            done += e.step()
            slot = next((x for x in e._slots
                         if x is not None and x.req.rid == "s"), None)
            if swap and not swapped and slot and len(slot.tokens) >= 3:
                if e.install_weights(model.state_dict()) != 2:
                    raise RuntimeError("fleet router parity (d): version")
                swapped = True
                pages = (pages, e._prefix.total_pages)
                # streams that ended before the swap, or in the windows
                # its flush consumed, ran under version 1 and say so
                old = {c.rid for c in done + e._flush_backlog}
        _check_launches("fleet router parity (d)", _launch_counts(),
                        _want_launches([(e.stats(), layers, 0)]))
        return {c.rid: c for c in done}, e.logit_log, pages, e.stats(), old

    got, got_log, pages, st, old = swap_run(True)
    want, want_log, _, _, _ = swap_run(False)
    same = all(np.array_equal(a, b) for rid in ("s", "t")
               for a, b in zip(got_log[rid], want_log[rid]))
    if (any(got[r].tokens != want[r].tokens for r in ("s", "t")) or not same
            or any(c.weights_version != (1 if r in old else 2)
                   for r, c in got.items()) or "s" in old
            or pages[0] == 0 or pages[1] != 0 or st["prefix_hits"] < 1):
        raise RuntimeError(
            f"fleet router parity (d): streams "
            f"{[got[r].tokens for r in ('s', 't')]} vs "
            f"{[want[r].tokens for r in ('s', 't')]}, logits bit-equal {same}, "
            f"versions {[c.weights_version for c in got.values()]}, prefix "
            f"pages before/after the swap {pages}, hits {st['prefix_hits']}")
    log(f"fleet router parity (d) same-weights swap after 3 tokens of a "
        f"prefix hit beside a second stream: streams and all "
        f"{sum(len(got_log[r]) for r in ('s', 't'))} logit rows bit-equal "
        f"to the "
        f"unswapped run; Completions stamped version 2 (version 1: "
        f"{sorted(old)}, done by the swap's flush); prefix cache flushed "
        f"({pages[0]} pages before, {pages[1]} after)")
    del model
    torch.cuda.empty_cache()


def _balanced_groups(systems, names, per_replica):
    """Request indices of each system prompt so that every replica (by the
    router's own placement) starts with ``per_replica`` streams: each
    replica's groups take its requests in turn."""
    from move2kube_tpu_torch.serving.fleet.router import (
        _rendezvous_score,
        prefix_hash,
    )

    owner = [max(names, key=lambda n, k=prefix_hash(s, "", 16):
                 _rendezvous_score(k, n)) for s in systems]
    groups = []
    for name in names:
        mine = [g for g, o in enumerate(owner) if o == name]
        if not mine:
            raise RuntimeError(f"fleet router slice: no system prompt lands "
                               f"on {name} ({owner})")
        groups += [mine[i % len(mine)] for i in range(per_replica)]
    return groups


def fleet_router_slice_phase(torch, model) -> dict:
    """The fleet at full width on one card: ``build_fleet`` with two
    replicas of the serving slice's model (Llama-8B, bf16, flash, seed 0),
    ``EngineConfig(max_batch=8, max_seq=2048, block_size=16,
    prefix_cache=True, max_loras=2, lora_rank=8)`` with the tenant spec
    FLEET_SPEC, and one prefill replica behind ``disagg_threshold=1024``.
    Traffic through ``Router.generate``, each request from its own client
    thread: 16 bronze requests on 4 system prompts of 512 tokens (seed 3;
    tails of 1-24 tokens, 64 new), placed 8 to a replica; after 16 decode
    steps on each replica, 4 gold requests of 64-256 tokens (seed 4, 32
    new) that preempt, 4 requests under two adapters (rank 8, A/B from
    seed 5 at 0.01 scale, 32 new) and 2 prompts of 1024-1536 tokens
    (seed 6, 32 new) through the prefill replica; when the gold requests
    are done, one ``router.swap`` of the same weights. Gates: each prompt
    group on one replica, at least 12 prefix hits, every preempted stream
    resumed to its full length and held by ``logit_gate`` against the same
    request run uninterrupted (ROUTE_GATE_REL, up to where the streams
    part), each adapter stream's first logits a base pass plus the plain
    delta by the bf16 rule, and the launches exactly what the replicas'
    and the prefill replica's passes imply. Then the fleet's tokens/s
    against one replica's, and an int8-kv engine with
    ``quant_audit_rate=0.5`` over 4 cold prefills (2 audits, drift under
    QUANT_GATE_REL). Returns the launch counts of the traffic and of the
    audit run."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        logit_gate,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.obs.tracing import SpanRecorder
    from move2kube_tpu_torch.serving.fleet import disagg as disagglib
    from move2kube_tpu_torch.serving.fleet.router import (
        RouterConfig,
        build_fleet,
    )

    cfg = model.cfg
    vocab, layers = cfg.vocab_size, cfg.num_layers
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16,
                         prefix_cache=True, max_loras=2, lora_rank=8,
                         sched_tenants=FLEET_SPEC)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    router = build_fleet(model, 2, econf, RouterConfig(
        sched_tenants=FLEET_SPEC, disagg_threshold=1024,
        deadline_s=FLEET_WAIT_S), device="cuda")
    pre = disagglib.PrefillReplica(model, econf, device="cuda")
    router.prefill_replicas.append(pre)
    engines = {r.name: r.engine for r in router.replicas}
    names = list(engines)
    rng = np.random.default_rng(5)
    adapters = {n: ((rng.normal(size=(cfg.d_model, 8)) * 0.01).astype(
        np.float32), (rng.normal(size=(8, vocab)) * 0.01).astype(np.float32))
        for n in ("lora-a", "lora-b")}
    submits, installs, swaps = [], {}, {}
    wire = {"encode": [], "decode": []}
    shared_log: dict = {}
    for name, eng in engines.items():
        for a_name, (a, b) in adapters.items():
            eng.register_adapter(a_name, a, b)
        eng.tracer = SpanRecorder(ring_seconds=3600.0)
        eng.capture_logits = True
        # one log for the fleet: a stream's rows stay in order when its
        # resume lands on the other replica (one replica holds it at a time)
        eng.logit_log = shared_log

        def submit(req, _orig=eng.submit, _name=name):
            submits.append((req.rid, _name, time.perf_counter()))
            return _orig(req)

        def install(req, *a, _orig=eng.install_prefilled, _name=name):
            t0 = time.perf_counter()
            ok, done = _orig(req, *a)
            if ok:
                installs[req.rid] = (_name, t0, time.perf_counter())
            return ok, done

        def install_weights(*a, _orig=eng.install_weights, _name=name,
                            **kw):
            t0 = time.perf_counter()
            version = _orig(*a, **kw)
            swaps[_name] = time.perf_counter() - t0
            return version

        eng.submit, eng.install_prefilled = submit, install
        eng.install_weights = install_weights
    to_bytes, from_bytes = disagglib.KVHandoff.to_bytes, (
        disagglib.KVHandoff.from_bytes)

    def timed_to_bytes(self):
        t0 = time.perf_counter()
        data = to_bytes(self)
        wire["encode"].append((self.rid, len(data), self.bucket,
                               time.perf_counter() - t0))
        return data

    def timed_from_bytes(data):
        t0 = time.perf_counter()
        h = from_bytes(data)
        wire["decode"].append((h.rid, time.perf_counter() - t0))
        return h

    disagglib.KVHandoff.to_bytes = timed_to_bytes
    disagglib.KVHandoff.from_bytes = staticmethod(timed_from_bytes)
    try:
        out = _router_traffic(router, engines, names, model.state_dict(),
                              vocab)
    finally:
        disagglib.KVHandoff.to_bytes = to_bytes
        disagglib.KVHandoff.from_bytes = classmethod(from_bytes.__func__)
    results, groups, reqs, swap = out
    launches = _launch_counts()
    stats = {n: e.stats() for n, e in engines.items()}
    _check_launches("fleet router slice", launches, _want_launches(
        [(st, layers, 0) for st in stats.values()]
        + [(pre.stats(), layers, 0)]))
    peak = torch.cuda.max_memory_allocated() / 2**30

    # placement: each prompt group's first submissions on one replica
    first = {}
    for rid, name, _ in submits:
        first.setdefault(rid, name)
    placed = {}
    for rid, g in groups.items():
        placed.setdefault(g, set()).add(first[rid])
    hits = sum(st["prefix_hits"] for st in stats.values())
    preempted = sum(st["preempted"] for st in stats.values())
    resumed = sorted({rid for rid, _, _ in submits
                      if sum(1 for r, _, _ in submits if r == rid) > 1})
    # every preemption, from the engines' own request roots: a stream
    # preempted after emitting tokens must come back through the journal
    # (a resume); one preempted before its first token (its prefix-hit
    # suffix just fed) restarts with an empty journal
    paused = [(s["attrs"]["rid"], s["attrs"]["tokens"])
              for e in engines.values() for s in e.tracer.snapshot()
              if s["name"] == "serve.request"
              and s["attrs"].get("finish_reason") == "preempted"]
    short = [rid for rid, r in reqs.items()
             if len(results[rid]["tokens"]) != r.max_new_tokens]
    lost = [rid for rid, n in paused if n and not results[rid].get("resumed")]
    if (any(len(v) != 1 for v in placed.values()) or hits < 12
            or preempted < 4 or len(paused) != preempted or short or lost):
        raise RuntimeError(
            f"fleet router slice: group placement {placed}, prefix hits "
            f"{hits} (want >= 12), preempted {preempted} (want >= 4; "
            f"{len(paused)} preempted roots), streams short of their length "
            f"{short}, preempted streams not resumed {lost}")

    # resumed streams against the same requests run uninterrupted
    ref = ServingEngine(model, EngineConfig(
        max_batch=8, max_seq=2048, block_size=16, admit_burst=0, max_loras=2,
        lora_rank=8), device="cuda")
    for a_name, (a, b) in adapters.items():
        ref.register_adapter(a_name, a, b)
    ref.capture_logits = True
    want = {c.rid: c.tokens for c in ref.run(
        [Request(rid, list(reqs[rid].prompt), reqs[rid].max_new_tokens,
                 adapter=reqs[rid].adapter) for rid in resumed])}
    worst, agreed = 0.0, []
    for rid, toks in want.items():
        rows = shared_log[rid]
        agree = _greedy_prefix(results[rid]["tokens"], toks)
        agreed.append(agree)
        for i in range(min(agree + 1, len(rows), len(ref.logit_log[rid]))):
            worst = max(worst, logit_gate(ref.logit_log[rid][i],
                                          rows[i])["max_rel_err"])
    if not worst < ROUTE_GATE_REL:
        raise RuntimeError(f"fleet router slice: resumed streams' logits "
                           f"against uninterrupted runs: max rel err "
                           f"{worst:.4f} (tol {ROUTE_GATE_REL})")
    del ref

    # adapter streams: first logits = a base pass + the plain delta
    lora_worst = 0.0
    eng0 = engines[names[0]]
    for rid, r in reqs.items():
        if not r.adapter:
            continue
        plen = len(r.prompt)
        ids = torch.zeros((1, eng0._bucket_for(plen)), dtype=torch.long,
                          device="cuda")
        ids[0, :plen] = torch.tensor(r.prompt, device="cuda")
        with torch.inference_mode():
            hidden = model(ids, return_hidden=True)[0, plen - 1].float()
            base_row = model._head(hidden[None])[0]
            a, b = (torch.from_numpy(t).cuda() for t in adapters[r.adapter])
            ref_row = (base_row + (hidden @ a) @ b).cpu().numpy()
        got_row = shared_log[rid][0]
        excess = (np.abs(got_row - ref_row)
                  - (BF16_ATOL + BF16_RTOL * np.abs(ref_row))).max()
        lora_worst = max(lora_worst, float(np.abs(got_row - ref_row).max()))
        if excess > 0:
            raise RuntimeError(f"fleet router slice: {rid}'s first logits "
                               f"outside the bf16 rule by {excess:.3e}")
    swap["install_s"] = swaps
    _router_report(engines, results, reqs, submits, installs, wire, stats,
                   swap, pre, peak, hits, preempted, paused, resumed, worst,
                   agreed, lora_worst, launches)
    tput = _fleet_throughput(torch, router, model, econf, vocab, adapters)
    for rep in router.replicas:
        rep.close()
    # the engines' wrapped submit and install close over the engines
    del router, engines, eng0, pre, shared_log
    gc.collect()
    torch.cuda.empty_cache()
    audit = _audit_run(torch, model)
    log(f"fleet router slice: tokens/s {tput}")
    return {"traffic": launches, "audit": audit}


def _router_traffic(router, engines, names, weights, vocab):
    """The slice's traffic (see ``fleet_router_slice_phase``); returns the
    router's answers by rid, the bronze requests' prompt groups, every
    request by rid, and the swap's result and time."""
    import numpy as np

    from move2kube_tpu_torch import Request, reset_launch_counts

    srng = np.random.default_rng(3)
    systems = [srng.integers(1, vocab, size=512).tolist() for _ in range(4)]
    tails = srng.integers(1, 25, size=16)
    order = _balanced_groups(systems, names, 8)
    reqs, groups = {}, {}
    for i, g in enumerate(order):
        rid = f"bronze{i}"
        groups[rid] = g
        reqs[rid] = Request(rid, systems[g] + srng.integers(
            1, vocab, size=int(tails[i])).tolist(), 64, tenant="bronze")
    grng = np.random.default_rng(4)
    gold = [Request(f"gold{i}", grng.integers(1, vocab, size=int(n)).tolist(),
                    32, tenant="gold")
            for i, n in enumerate(grng.integers(64, 257, size=4))]
    lrng = np.random.default_rng(5)
    lora = [Request(f"lora{i}", lrng.integers(1, vocab, size=int(n)).tolist(),
                    32, adapter=("lora-a", "lora-b")[i % 2])
            for i, n in enumerate(lrng.integers(64, 193, size=4))]
    drng = np.random.default_rng(6)
    dis = [Request(f"disagg{i}", drng.integers(1, vocab,
                                                size=int(n)).tolist(), 32)
           for i, n in enumerate(drng.integers(1024, 1537, size=2))]
    for r in gold + lora + dis:
        reqs[r.rid] = r
    results, errors = {}, []

    def send(r):
        kw = {"tenant": r.tenant} if r.tenant else {}
        if r.adapter:
            kw["adapter"] = r.adapter
        return _client(router, results, errors, r.rid, r.prompt,
                       r.max_new_tokens, **kw)

    def queued(rid):
        return any(r.rid == rid for e in engines.values()
                   for r in list(e._pending))

    reset_launch_counts()
    bronze = [send(reqs[f"bronze{i}"]) for i in range(16)]
    _wait_for(lambda: all(e.stats()["decode_steps"] >= 16
                          for e in engines.values()),
              "16 decode steps on each replica")
    # the gold requests reach full replicas with nothing queued ahead of
    # them: the replicas' step threads stop (each after its step) while
    # the gold requests queue, then start again. Otherwise a preempted
    # stream's resume, queued first, holds the head of the queue (it
    # cannot preempt) and the next gold request waits behind it
    for rep in router.replicas:
        rep.close()
    gold_t = [send(r) for r in gold]
    _wait_for(lambda: all(queued(r.rid) for r in gold),
              "the gold requests to queue")
    for rep in router.replicas:
        rep.revive()
    _wait_for(lambda: not any(queued(r.rid) for r in gold),
              "the gold requests' admission")
    rest = [send(r) for r in lora + dis]
    _join(gold_t, "fleet router slice gold")
    t0 = time.perf_counter()
    swap = router.swap(variables=weights)
    swap["seconds"] = time.perf_counter() - t0
    _join(bronze + rest, "fleet router slice")
    if errors:
        raise RuntimeError(f"fleet router slice: {errors}")
    if swap["swapped"] != 2 or swap["weights_version"] != 2:
        raise RuntimeError(f"fleet router slice: swap {swap}")
    return results, groups, reqs, swap


def _router_report(engines, results, reqs, submits, installs, wire, stats,
                   swap, pre, peak, hits, preempted, paused, resumed, worst,
                   agreed, lora_worst, launches) -> None:
    """Print the slice's numbers: TTFT by tenant and route, the handoffs,
    preemptions and resume times, the swap, memory."""
    import numpy as np

    roots = []
    for eng in engines.values():
        roots += [s for s in eng.tracer.snapshot()
                  if s["name"] == "serve.request"]
    roots.sort(key=lambda s: s["ts_unix"])
    first_ttft, resume_ttft = {}, []
    for s in roots:
        rid, ttft = s["attrs"]["rid"], s["attrs"].get("ttft_s")
        if ttft is None:
            continue
        if rid in first_ttft:
            resume_ttft.append(ttft)
        else:
            first_ttft[rid] = ttft
    by_tenant = {}
    for rid, r in reqs.items():
        if rid in first_ttft:
            key = r.tenant or ("adapter" if r.adapter else "default")
            by_tenant.setdefault(key, []).append(first_ttft[rid])
    parts = [f"{k} ({len(v)}): p50 {_pctl(v, 50):.1f} p95 "
             f"{_pctl(v, 95):.1f} ms" for k, v in sorted(by_tenant.items())]
    dis = [rid for rid in reqs if rid.startswith("disagg")]
    dis_ttft = [(installs[rid][2] - results[rid]["t_start"]) * 1e3
                for rid in dis if rid in installs]
    enc = ", ".join(f"{rid} bucket {bk}: {n / 1e6:.1f} MB in {dt:.3f} s"
                    for rid, n, bk, dt in wire["encode"])
    dec = ", ".join(f"{dt:.3f} s" for _, dt in wire["decode"])
    inst = ", ".join(f"{(installs[r][2] - installs[r][1]) * 1e3:.1f} ms"
                     for r in dis if r in installs)
    log(f"fleet router slice: llama_8b bf16, 2 replicas x max_batch 8 on one"
        f" card sharing the weights, + 1 prefill replica; {len(reqs)} "
        f"requests; TTFT by tenant (first admission): {'; '.join(parts)}; "
        f"disagg route TTFT (to the install) "
        f"{', '.join(f'{t:.1f}' for t in dis_ttft)} ms")
    log(f"fleet router slice: disagg handoffs: encode {enc}; decode {dec}; "
        f"install {inst}; prefill replica {pre.stats()['prefills']} prefills "
        f"in {pre.stats()['prefill_time_s']:.3f} s")
    per_replica = ", ".join(f"{n} {st['preempted']}"
                            for n, st in stats.items())
    steps = ", ".join(
        f"{n} {st['decode_time_s'] / max(1, st['decode_steps']) * 1e3:.2f} "
        f"ms/step over {st['decode_steps']} steps"
        for n, st in stats.items())
    resume = (f"p50 {_pctl(resume_ttft, 50):.1f} p95 "
              f"{_pctl(resume_ttft, 95):.1f} ms" if resume_ttft else "none")
    log(f"fleet router slice: preempted {preempted} times ({per_replica}; "
        f"after {sorted(n for _, n in paused)} tokens); {len(resumed)} "
        f"streams resubmitted, every one completed to its full length; "
        f"resume TTFT {resume} over {len(resume_ttft)} resumes; "
        f"resumed streams against uninterrupted runs: max rel logit err "
        f"{worst:.4f} (tol {ROUTE_GATE_REL}), streams agree for {agreed} "
        f"tokens; prefix hits {hits}; adapter streams' first logits vs a "
        f"base pass + the plain delta: max abs err {lora_worst:.3e}")
    own = ", ".join(f"{n} {t * 1e3:.1f} ms"
                    for n, t in sorted(swap["install_s"].items()))
    log(f"fleet router slice: swap of the same weights {swap['seconds']:.3f}"
        f" s for {swap['swapped']} replicas (version "
        f"{swap['weights_version']}; install_weights itself {own}, the rest "
        f"the wait for each replica's step lock); peak memory {peak:.2f} "
        f"GiB; decode "
        f"{steps}; launches {launches}")


def _fleet_throughput(torch, router, model, econf, vocab,
                      adapters) -> str:
    """The fleet's tokens/s (16 requests through the router at once, 8 on
    each replica by its placement, each replica's thread stepping its
    engine) against one replica's (one replica's 8 on a lone engine):
    128-token prompts drawn from seed 7, 64 new tokens. Then what the
    LoRA delta costs a decode step: one profiled step at 8 of 8 slots, 4
    of them under an adapter, beside the same step on an engine with no
    adapters."""
    import numpy as np

    from move2kube_tpu_torch import Request, ServingEngine
    from move2kube_tpu_torch.serving.fleet.router import (
        _rendezvous_score,
        prefix_hash,
    )

    names = [r.name for r in router.replicas]
    rng = np.random.default_rng(7)
    placed = {n: [] for n in names}
    while min(len(v) for v in placed.values()) < 8:
        p = rng.integers(1, vocab, size=128).tolist()
        key = prefix_hash(p, "", 16)
        owner = max(names, key=lambda n: _rendezvous_score(key, n))
        if len(placed[owner]) < 8:
            placed[owner].append(p)
    before = {r.name: r.engine.stats() for r in router.replicas}
    results, errors = {}, []
    t0 = time.perf_counter()
    threads = [_client(router, results, errors, f"tput{n}{i}", p, 64)
               for n in names for i, p in enumerate(placed[n])]
    _join(threads, "fleet throughput")
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    split = {}
    for out in results.values():
        split[out["replica"]] = split.get(out["replica"], 0) + 1
    steps = []
    for r in router.replicas:
        st, st0 = r.engine.stats(), before[r.name]
        n = st["decode_steps"] - st0["decode_steps"]
        dt = st["decode_time_s"] - st0["decode_time_s"]
        steps.append(f"{r.name} {dt / max(1, n) * 1e3:.2f} ms/step over {n}")
    eng = ServingEngine(model, econf, device="cuda")
    t0 = time.perf_counter()
    done = eng.run([Request(f"one{i}", list(p), 64)
                    for i, p in enumerate(placed[names[0]])])
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_step = eng.stats()["decode_time_s"] / eng.stats()["decode_steps"]
    if errors or len(results) != 16 or len(done) != 8:
        raise RuntimeError(f"fleet throughput: {errors}")
    fleet = 16 * 64 / fleet_wall
    one = 8 * 64 / one_wall
    out = (f"fleet {fleet:.1f} (16 x 64 tokens in {fleet_wall:.3f} s, split "
           f"{split}; {', '.join(steps)}) against one replica's {one:.1f} "
           f"(8 x 64 in {one_wall:.3f} s, {one_step * 1e3:.2f} ms/step): "
           f"{fleet / one:.3f}x")
    del eng
    # the LoRA delta in a decode step: 8 rows, 4 under an adapter
    busy = {}
    for label, lora in (("4 of 8 rows under an adapter", True),
                        ("no adapters", False)):
        e = ServingEngine(model, dataclasses.replace(
            econf, admit_burst=0, max_loras=2 if lora else 0), device="cuda")
        if lora:
            for a_name, (a, b) in adapters.items():
                e.register_adapter(a_name, a, b)
        for i, p in enumerate(placed[names[1]]):
            e.submit(Request(f"l{i}", list(p), 16,
                             adapter="lora-a" if lora and i % 2 else ""))
        e.step()  # admits the 8 (prefills) and decodes
        busy[lora] = _profiled(torch, f"one decode step at 8 of 8 slots, "
                               f"{label}", e.step)
        del e
    return out + (f"; a decode step's device busy time with 4 adapter rows "
                  f"{busy[True]:.3f} ms, without {busy[False]:.3f} ms")


def _audit_run(torch, model) -> dict:
    """An int8-kv engine on the bf16 model with ``quant_audit_rate=0.5``
    over 4 cold prefills: exactly 2 audits, drift under QUANT_GATE_REL,
    and ``paged_decode_int8`` and the audits' ``flash_fwd`` in its
    launches, exactly as its passes imply."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        reset_launch_counts,
    )

    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16,
                         quant="int8-kv", quant_audit_rate=0.5)
    eng = ServingEngine(model, econf, device="cuda")
    rng = np.random.default_rng(8)
    reqs = [Request(f"q{i}", rng.integers(1, model.cfg.vocab_size,
                                          size=int(n)).tolist(), 8)
            for i, n in enumerate(rng.integers(128, 513, size=4))]
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    st = eng.stats()
    _check_launches("audit run", launches, _want_launches(
        [(st, model.cfg.num_layers, 0)], paged="paged_decode_int8"))
    if not (st["quant_audits"] == 2 and st["passes"]["audit"] == 2
            and st["quant_drift_max_rel"] < QUANT_GATE_REL
            and launches["paged_decode_int8"] > 0):
        raise RuntimeError(f"audit run: audits {st['quant_audits']}, passes "
                           f"{st['passes']}, drift max "
                           f"{st['quant_drift_max_rel']} (tol "
                           f"{QUANT_GATE_REL})")
    log(f"audit run: llama_8b int8-kv, quant_audit_rate 0.5, 4 cold "
        f"prefills of {[len(r.prompt) for r in reqs]} tokens: "
        f"{st['quant_audits']} audits through the bf16 model, drift last "
        f"{st['quant_drift_last_rel']:.4f} max {st['quant_drift_max_rel']:.4f}"
        f" (gate {QUANT_GATE_REL}); wall {wall:.3f} s; launches {launches}")
    del eng
    torch.cuda.empty_cache()
    return launches


def _train_run(torch, cfg, policy_name, batches, remat=True,
               first_grads=None):
    """Steps of the LM train step on fresh fp32 master weights drawn from
    SEED (``init_gpt2`` for a GPT-2 config, else ``init_llama``), AdamW
    (lr 1e-4, weight decay 0.1); returns the state, the step function and
    the losses and grad norms (tensors). A dict passed as ``first_grads``
    receives a copy of each parameter's first-step gradient."""
    from move2kube_tpu_torch import (
        GPT2Config,
        TrainState,
        adamw,
        init_gpt2,
        init_llama,
        instrument_optimizer,
        make_lm_train_step,
        policy,
    )

    pol = policy(policy_name)
    init = init_gpt2 if isinstance(cfg, GPT2Config) else init_llama
    model = init(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    opt = instrument_optimizer(pol.wrap_optimizer(adamw(
        model.parameters(), 1e-4, weight_decay=0.1)))
    state = TrainState(model, opt)
    step = make_lm_train_step(remat=remat, precision=pol)
    losses, norms = [], []
    for i, ids in enumerate(batches):
        state, loss = step(state, {"input_ids": ids})
        losses.append(loss)
        norms.append(opt.grad_norm.clone())
        if i == 0 and first_grads is not None:
            first_grads.update((n, p.grad.clone())
                               for n, p in model.named_parameters())
    return state, step, losses, norms


def train_parity_phase(torch) -> None:
    import numpy as np

    from move2kube_tpu_torch import llama_8b

    rng = np.random.default_rng(SEED + 6)
    cfg = dataclasses.replace(llama_8b(), num_layers=2)
    batches = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (3, 2, 1024))).cuda()
    runs, grads = {}, {}
    for impl in ("flash", "dense"):
        grads[impl] = {}
        state, _, losses, norms = _train_run(
            torch, dataclasses.replace(cfg, attn_impl=impl), "fp32",
            batches, first_grads=grads[impl])
        runs[impl] = ([float(x) for x in losses], float(norms[0]))
        del state
        torch.cuda.empty_cache()
    (fl, fn), (dl, dn) = runs["flash"], runs["dense"]
    worst = max(abs(a - b_) / abs(b_) for a, b_ in zip(fl + [fn], dl + [dn]))
    leaf_err = {n: float(torch.linalg.vector_norm(grads["flash"][n] - g)
                         / torch.linalg.vector_norm(g))
                for n, g in grads["dense"].items()}
    worst_leaf = max(leaf_err, key=leaf_err.get)
    del grads
    torch.cuda.empty_cache()
    if not (worst <= FP32_TRAIN_RTOL
            and leaf_err[worst_leaf] <= FP32_GRAD_RTOL):
        raise RuntimeError(
            f"train parity: flash losses {fl} grad norm {fn} vs dense {dl} "
            f"/ {dn}: rel err {worst:.3e} (tol {FP32_TRAIN_RTOL}); first-"
            f"step gradient of {worst_leaf} rel err "
            f"{leaf_err[worst_leaf]:.3e} (tol {FP32_GRAD_RTOL})")
    log(f"train parity: llama_8b widths, 2 layers, fp32, batch 2 x 1024, 3 "
        f"AdamW steps: flash losses {fl} vs dense {dl}, first grad norm "
        f"{fn:.6f} vs {dn:.6f}, max rel err {worst:.3e} (tol "
        f"{FP32_TRAIN_RTOL}); first-step gradients of {len(leaf_err)} "
        f"parameters, worst |g - g_dense| / |g_dense| "
        f"{leaf_err[worst_leaf]:.3e} ({worst_leaf}, tol {FP32_GRAD_RTOL})")
    bf16_train_parity(torch, cfg, batches)


def bf16_train_parity(torch, cfg, batches, label="llama_8b widths") -> None:
    """The same weights and batches in the bf16 policy: 3 steps with the
    flash kernels (the tensor-core forward, and the backward kernels
    reading its o and lse) against dense attention (GPT-2, which has no
    einsum path: the plain attention swapped in), held to
    source/validate.py's loss and grad-norm gates."""
    runs = {}
    for impl in ("flash", "dense"):
        with _attention_impl(cfg, impl) as run_cfg:
            state, _, losses, norms = _train_run(torch, run_cfg, "bf16",
                                                 batches)
        runs[impl] = ([float(x) for x in losses], float(norms[0]))
        del state
        torch.cuda.empty_cache()
    (fl, fn), (dl, dn) = runs["flash"], runs["dense"]
    loss_rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(fl, dl))
    norm_rel = abs(fn - dn) / abs(dn)
    if not (loss_rel <= BF16_TRAIN_LOSS_REL
            and norm_rel <= BF16_TRAIN_GRAD_NORM_REL):
        raise RuntimeError(
            f"bf16 train parity: flash losses {fl} grad norm {fn} vs dense "
            f"{dl} / {dn}: loss rel err {loss_rel:.3e} (tol "
            f"{BF16_TRAIN_LOSS_REL}), grad norm rel err {norm_rel:.3e} (tol "
            f"{BF16_TRAIN_GRAD_NORM_REL})")
    log(f"train parity: {label}, 2 layers, bf16 policy, batch 2 x "
        f"1024, 3 AdamW steps: flash losses {fl} vs dense {dl}, max rel err "
        f"{loss_rel:.3e} (tol {BF16_TRAIN_LOSS_REL}); first grad norm "
        f"{fn:.6f} vs {dn:.6f}, rel err {norm_rel:.3e} (tol "
        f"{BF16_TRAIN_GRAD_NORM_REL})")


def train_slice_phase(torch):
    import numpy as np

    from move2kube_tpu_torch import llama_8b, pick_chunk, reset_launch_counts
    from move2kube_tpu_torch.ops.attention import KERNELS

    layers, batch, seq, timed = 8, 4, 2048, 5
    cfg = dataclasses.replace(llama_8b(), num_layers=layers,
                              attn_impl="flash")
    rng = np.random.default_rng(SEED + 7)
    batches = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (timed + 2, batch, seq))).cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, _, _ = _train_run(torch, cfg, "bf16", batches[:1])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.model.parameters())
    chunk = pick_chunk(cfg.vocab_size, 2048)
    log(f"train slice: llama_8b widths, {layers} layers ({n_params / 1e9:.3f}"
        f" B params, fp32 masters drawn on the card), bf16 policy, AdamW, "
        f"remat, head-folded CE in chunks of {chunk}; set-up and warm-up "
        f"step {time.perf_counter() - t0:.1f} s")
    opt = state.optimizer
    losses, norms = [], []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids in batches[1:timed + 1]:
        state, loss = step(state, {"input_ids": ids})
        losses.append(loss)
        norms.append(opt.grad_norm.clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    want = {"flash_fwd": 2 * layers * timed, "flash_bwd_dq": layers * timed,
            "flash_bwd_dkv": layers * timed, "paged_decode": 0,
            "paged_decode_int8": 0}
    if launches != want:
        raise RuntimeError(f"train slice: launches {launches}, expected "
                           f"{want} ({layers} layers x {timed} steps)")
    if not all(np.isfinite(losses + norms)):
        raise RuntimeError(f"train slice: losses {losses} grad norms {norms}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train slice: {timed} steps of batch {batch} x {seq}: "
        f"{wall / timed * 1e3:.1f} ms/step, {timed * batch * seq / wall:.1f} "
        f"tokens/s, peak memory {peak:.2f} GiB; losses {losses}; grad norms "
        f"{norms}")
    log(f"train slice: launches {launches} = {layers} layers x {timed} steps"
        " x (forward + remat recompute, dq, dkv)")
    _profiled(torch, f"one training step (batch {batch} x {seq})",
              lambda: step(state, {"input_ids": batches[-1]}))
    return launches


def _profiled(torch, label: str, fn) -> float:
    """Run ``fn`` under torch.profiler; print its wall time, the device's
    busy time (kernels on one stream do not overlap, so their times add
    up to it), the kernels that took most of it and the port's own
    kernels, and return the busy time in ms. Host-side operator entries
    also carry their kernels' device time; only the kernels' own entries
    are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from move2kube_tpu_torch.ops.attention import KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # a user annotation (``Optimizer.step#AdamW.step``) also has a range
    # on the device that spans its kernels: count the kernels only
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(_dev_us(e) for e in events)
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in events)} kernels")
    ranked = sorted(events, key=_dev_us, reverse=True)
    # the 8 largest, and the port's own kernels wherever they rank
    for i, e in enumerate(ranked):
        if i < 8 or any(k.name in e.key for k in KERNELS):
            log(f"  {_dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return busy_us / 1e3


def profile_phase(torch, model, econf, rng) -> float:
    """Where the slice's time goes: one prefill of a 1000-token prompt,
    then 4 decode steps at a full batch of 8 (prompts of 512). Returns
    the device busy time of one decode step."""
    from move2kube_tpu_torch import Request, ServingEngine

    vocab = model.cfg.vocab_size
    eng = ServingEngine(model, dataclasses.replace(econf, admit_burst=0),
                        device="cuda")
    eng.submit(Request("long", rng.integers(1, vocab, size=1000).tolist(),
                       16))
    _profiled(torch, f"prefill (1000 tokens, bucket 1024) + 1 decode step "
              f"at 1 of 8 slots (quant {econf.quant})", eng.step)
    for i in range(7):
        eng.submit(Request(f"b{i}", rng.integers(1, vocab,
                                                 size=512).tolist(), 16))
    eng.step()  # admits the 7 (prefills) and decodes
    return _profiled(torch, f"4 decode steps at 8 of 8 slots (quant "
                     f"{econf.quant})",
                     lambda: [eng.step() for _ in range(4)]) / 4


def _plain_flash(torch):
    """``flash_attention`` with the flash kernels' plain versions in their
    place, forward (with its logsumexp) and backward: what the cost
    model's count of the kernels must equal."""
    from move2kube_tpu_torch.ops import attention as att

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale):
            o, lse = att.reference_attention_lse(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.scale = causal, scale
            return o

        @staticmethod
        def backward(ctx, g):
            q, k, v, o, lse = ctx.saved_tensors
            return (*att.flash_attention_bwd_reference(
                q, k, v, o, lse, g.contiguous(), ctx.causal, ctx.scale),
                None, None)

    def flash(q, k, v, *, causal=False, scale=None):
        return PlainFlash.apply(q, k, v, causal,
                                q.shape[-1] ** -0.5 if scale is None
                                else scale)

    return flash


@contextlib.contextmanager
def _counted_attention(torch, model, impl: str):
    """``model`` (a Llama) with its attention swapped for a count only:
    ``"plain"`` runs the flash kernels' plain versions, ``"dense"`` the
    model's own dense attention (``attn_impl``)."""
    from move2kube_tpu_torch.models import llama

    saved_fn = llama.flash_attention
    saved_cfgs = [model.cfg] + [layer.cfg for layer in model.layers]
    if impl == "plain":
        llama.flash_attention = _plain_flash(torch)
    else:
        cfg = dataclasses.replace(model.cfg, attn_impl="dense")
        model.cfg = cfg
        for layer in model.layers:
            layer.cfg = cfg
    try:
        yield
    finally:
        llama.flash_attention = saved_fn
        model.cfg = saved_cfgs[0]
        for layer, cfg in zip(model.layers, saved_cfgs[1:]):
            layer.cfg = cfg


def _metric(text: str, sample: str) -> float:
    """The value of one sample line of a Prometheus text (0 when the
    series is absent)."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def obs_train_phase(torch) -> dict:
    """The compute-side obs hooks around the training slice's step
    (Llama-8B widths, 8 layers, batch 4 x 2048, bf16 policy, AdamW,
    remat): the steps' time with the health recorder and StepTelemetry
    off and on; the cost model's FLOPs against the plain versions' count
    of the same step; an Inf planted in a middle layer's gradient, named
    by first_bad_group in the ``<flight>.numerics`` sidecar and moving
    the counters by one; and the ``<flight>.mem`` sidecar read back.
    Returns the kernels' launches."""
    import tempfile

    import numpy as np

    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_llama,
        instrument_optimizer,
        llama_8b,
        make_lm_train_step,
        policy,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.models.train import StepTelemetry
    from move2kube_tpu_torch.obs import (
        DiagWatchdog,
        Registry,
        SpanRecorder,
        chip_spec,
        costmodel,
        install_memory_snapshot,
        numerics,
        write_memory_snapshot,
    )
    from move2kube_tpu_torch.ops.attention import KERNELS

    t_phase = time.perf_counter()
    layers, batch, seq, block = 8, 4, 2048, 3
    cfg = dataclasses.replace(llama_8b(), num_layers=layers,
                              attn_impl="flash")
    rng = np.random.default_rng(SEED + 11)
    ids = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4 * block + 4, batch, seq))).cuda()
    batches = iter([{"input_ids": x} for x in ids])
    pol = policy("bf16")
    model = init_llama(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    opt = pol.wrap_optimizer(adamw(model.parameters(), 1e-4,
                                   weight_decay=0.1))
    state = TrainState(model, opt)
    step = make_lm_train_step(remat=True, precision=pol)
    reg, tracer = Registry(), SpanRecorder()
    telem = StepTelemetry(registry=reg, items_per_step=batch * seq,
                          tracer=tracer)
    telem.record_precision(pol)
    state, _ = step(state, next(batches))  # warm-up, uncounted
    torch.cuda.synchronize()
    reset_launch_counts()
    instrument_optimizer(opt)
    n = 1

    def run_block(on: bool) -> float:
        nonlocal state, n
        opt.record_grad_norm = opt.record_health = on
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(block):
            if on:
                state, _ = telem.timed_step(n, step, state, next(batches),
                                            sync=i == block - 1)
            else:
                state, _ = step(state, next(batches))
            n += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / block

    # off and on alternate, so a drift of the card's clocks hits both
    off_s, on_s = [], []
    for _ in range(2):
        off_s.append(run_block(False))
        on_s.append(run_block(True))
    off, on = sum(off_s) / len(off_s), sum(on_s) / len(on_s)
    params = opt.params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        opt._record_health(params)
    torch.cuda.synchronize()
    rec_ms = (time.perf_counter() - t0) / 3 * 1e3
    _profiled(torch, "the health recorder (one update's summaries)",
              lambda: opt._record_health(params))
    overhead = 100.0 * (on / off - 1.0)
    log(f"obs train: llama_8b widths, {layers} layers, batch {batch} x "
        f"{seq}, bf16 policy, AdamW, remat ({CARD}): {off * 1e3:.1f} ms/step"
        f" with the health recorder and StepTelemetry off, {on * 1e3:.1f} "
        f"ms/step with both on (blocks of {block} steps, off "
        f"{[round(x * 1e3, 1) for x in off_s]} ms, on "
        f"{[round(x * 1e3, 1) for x in on_s]} ms): telemetry overhead "
        f"{overhead:.2f}% of step time (the reference's budget is 3%); the "
        f"health recorder alone {rec_ms:.2f} ms a step "
        f"({len(opt.health_names)} groups, gradients and parameters)")

    # the cost model: the step through the kernels, then the same step
    # with the kernels' plain versions and with dense attention, counted
    # with the optimizer held
    b0 = next(batches)
    telem.record_cost_model(step, state, b0)
    report = telem._cost_report
    if report is None or not report.flops:
        raise RuntimeError("obs train: record_cost_model left no report")
    with _counted_attention(torch, model, "plain"):
        plain = costmodel.analyze_step_fn(step, state, b0)
    torch.cuda.empty_cache()
    with _counted_attention(torch, model, "dense"):
        dense = costmodel.analyze_step_fn(step, state, b0)
    torch.cuda.empty_cache()
    # the flight sidecar describes the step the run takes, not the counts
    costmodel.note_memory_report(report)
    hd = cfg.d_model // cfg.num_heads
    # the plain flash backward recomputes P from the logsumexp: one
    # q.k^T product a layer more than dense attention's autograd
    recompute = layers * 2 * batch * cfg.num_heads * seq * seq * hd
    rel_plain = abs(report.flops - plain.flops) / plain.flops
    rel_dense = abs(report.flops - (dense.flops + recompute)) / (
        dense.flops + recompute)
    if not (rel_plain <= OBS_FLOPS_REL and rel_dense <= OBS_FLOPS_REL):
        raise RuntimeError(
            f"obs train: cost model FLOPs {report.flops:.6e} vs the plain "
            f"versions' {plain.flops:.6e} (rel {rel_plain:.3e}) and dense "
            f"{dense.flops:.6e} + recompute {recompute:.6e} (rel "
            f"{rel_dense:.3e}); tol {OBS_FLOPS_REL}")
    spec, assumed = chip_spec()
    mfu = report.mfu(on, spec)
    log(f"obs train: cost model ({CARD}; spec {spec.name}, assumed "
        f"{assumed}): {report.flops:.6e} FLOPs/step through the kernels, the"
        f" plain versions' count {plain.flops:.6e} (rel {rel_plain:.2e}), "
        f"dense attention's {dense.flops:.6e} + the flash backward's "
        f"recompute {recompute:.6e} (rel {rel_dense:.2e}); "
        f"{report.bytes_accessed:.6e} bytes accessed (unfused bound), "
        f"roofline {report.roofline(spec)}; MFU {100 * mfu:.2f}% at "
        f"{on * 1e3:.1f} ms/step; peak {report.peak_hbm_bytes / 2**30:.2f} "
        f"GiB ({report.memory})")

    # an Inf planted in a middle layer's gradient
    flight = tempfile.mkdtemp(prefix="m2kt-obs-")
    saved_env = os.environ.get("M2KT_FLIGHT_PATH")
    os.environ["M2KT_FLIGHT_PATH"] = os.path.join(flight, "m2kt-flight.json")
    try:
        dog = DiagWatchdog(registry=reg, tracer=tracer,
                           out_dir=os.path.join(flight, "diag"),
                           profile_seconds=0.0)
        telem.watchdog = dog
        bad = layers // 2
        weight = model.layers[bad].gate_up.weight
        row = torch.zeros((1,), dtype=torch.long, device="cuda")
        hook = weight.register_hook(
            lambda g: g.index_fill(0, row, float("inf")))
        before = _metric(reg.render(), "m2kt_train_nonfinite_steps_total")
        state, loss = telem.timed_step(n, step, state, next(batches),
                                       sync=True)
        hook.remove()
        dog.wait()
        after = reg.render()
        doc = numerics.read_sidecar()
        want = {g: (cfg.d_model if g == f"layer_{bad}" else 0)
                for g in opt.health_names}
        got = ({g: int(f["grad_nonfinite"] + f["param_nonfinite"])
                for g, f in doc["groups"].items()} if doc else None)
        moved = (_metric(after, "m2kt_train_nonfinite_steps_total") - before,
                 _metric(after, 'm2kt_diag_captures_total{reason='
                         '"nonfinite"}'))
        if (doc is None or doc["first_bad_group"] != f"layer_{bad}"
                or got != want or moved != (1.0, 1.0)
                or not np.isfinite(float(loss))):
            raise RuntimeError(
                f"obs train: planted Inf in layer_{bad}: sidecar "
                f"{None if doc is None else doc['first_bad_group']}, "
                f"non-finite by group {got} (want {want}), counters moved "
                f"{moved}, loss {float(loss)}")
        log(f"obs train: an Inf row planted in layers.{bad}.gate_up's "
            f"gradient: first_bad_group {doc['first_bad_group']!r}; the "
            f"sidecar {numerics.sidecar_path()} counts "
            f"{want[f'layer_{bad}']} non-finite entries there and none "
            f"elsewhere; m2kt_train_nonfinite_steps_total and the "
            f"watchdog's nonfinite captures moved by one; m2kt_train_mfu "
            f"{_metric(after, 'm2kt_train_mfu'):.4f} at that step")
        mem_path = costmodel.mem_snapshot_path()
        install_memory_snapshot(mem_path)
        write_memory_snapshot()
        with open(mem_path, encoding="utf-8") as f:
            mem = json.load(f)
        keys = {"memory_analysis", "peak_hbm_bytes", "live_buffers",
                "written_unix", "pid"}
        live = mem.get("live_buffers", {})
        if (set(mem) != keys or mem["memory_analysis"] != report.memory
                or set(live) != {"count", "total_bytes", "top"}
                or not live["total_bytes"] > 0):
            raise RuntimeError(f"obs train: memory sidecar {mem}")
        log(f"obs train: memory sidecar {mem_path}: keys {sorted(mem)}; "
            f"{live['count']} live allocations, "
            f"{live['total_bytes'] / 2**30:.2f} GiB, the largest "
            f"{live['top'][0]['bytes'] / 2**30:.3f} GiB")
    finally:
        if saved_env is None:
            os.environ.pop("M2KT_FLIGHT_PATH", None)
        else:
            os.environ["M2KT_FLIGHT_PATH"] = saved_env
    launches = {k.name: k.launches for k in KERNELS}
    kernel_steps = 4 * block + 2  # timed, the cost model's, the planted
    want = {"flash_fwd": 2 * layers * kernel_steps,
            "flash_bwd_dq": layers * kernel_steps,
            "flash_bwd_dkv": layers * kernel_steps, "paged_decode": 0,
            "paged_decode_int8": 0}
    if launches != want:
        raise RuntimeError(f"obs train: launches {launches}, expected {want}")
    del state, model, opt, telem, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"obs train: launches {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _http(url: str, doc=None, headers=None, timeout=120):
    """(status, body) of a GET (``doc`` None) or a JSON POST; an HTTP
    error's status and body are returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if doc is None else json.dumps(doc).encode(),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def obs_serve_phase(torch, model) -> tuple[dict, dict]:
    """The pod-side hooks around the full-depth Llama-8B bf16 engine (the
    serving slice's model): a TelemetryServer on port 0 over the engine's
    registry, its tracer and a UsageLedger fed by ``engine_source``; four
    requests with ``cost_report()`` called between two decode steps
    (streams, passes and launches held to a run without it); the
    endpoints scraped over HTTP; one ``/profile`` capture. Then
    ``cost_report()`` on an int8-kv engine at 2 layers of the same
    widths. Returns the launches of the bf16 run and of the int8 one."""
    import glob
    import tempfile

    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_8b,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.obs import (
        SpanRecorder,
        TelemetryServer,
        UsageLedger,
        engine_source,
    )
    from move2kube_tpu_torch.ops.attention import KERNELS

    t_phase = time.perf_counter()
    cfg = model.cfg
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    rng = np.random.default_rng(SEED + 12)
    reqs = [Request(f"o{i}", rng.integers(1, cfg.vocab_size,
                                          size=int(n)).tolist(), 24)
            for i, n in enumerate(rng.integers(64, 513, size=4))]
    base = ServingEngine(model, econf, device="cuda", tracer=SpanRecorder())
    want_tokens = {c.rid: c.tokens for c in base.run(reqs)}
    want_passes = base.stats()["passes"]
    del base
    tracer = SpanRecorder()
    eng = ServingEngine(model, econf, device="cuda", tracer=tracer)
    ledger = UsageLedger(registry=eng.registry, role="decode")
    ledger.add_source(engine_source(eng), "engine")
    profile_dir = tempfile.mkdtemp(prefix="m2kt-profile-")
    srv = TelemetryServer(
        port=0, registry=eng.registry, profile_dir=profile_dir,
        readiness=lambda: "draining" if eng.draining else "serving",
        tracer=tracer, ledger=ledger).start()
    try:
        reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        done, steps, report = [], 0, None
        while eng.has_work():
            done += eng.step()
            steps += 1
            if steps == 3:
                running = sum(1 for s in eng._slots if s is not None)
                t0 = time.perf_counter()
                report = eng.cost_report()
                cost_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
        ledger.snapshot()
        got_tokens = {c.rid: c.tokens for c in done}
        passes = eng.stats()["passes"]
        layers, buckets = cfg.num_layers, len(eng.buckets)
        want = {k.name: 0 for k in KERNELS}
        want["flash_fwd"] = layers * (passes["prefill"] + buckets)
        want["paged_decode"] = layers * (passes["decode"] + 1)
        if (report is None or got_tokens != want_tokens
                or passes != want_passes or launches != want):
            raise RuntimeError(
                f"obs serve: cost_report mid-run: streams equal "
                f"{got_tokens == want_tokens}, passes {passes} vs "
                f"{want_passes}, launches {launches} vs {want} (the "
                f"requests' passes plus one flash forward a layer a bucket "
                f"and one paged decode a layer)")
        log(f"obs serve: llama_8b, {layers} layers, bf16 ({CARD}): 4 "
            f"requests; cost_report() between decode steps 3 and 4 with "
            f"{running} streams running took {cost_s:.3f} s; the streams "
            f"equal a run without it, passes {passes} are the requests' "
            f"own, launches {launches} are theirs plus the report's "
            f"{buckets} prefill buckets and one decode pass a layer")
        for name, entry in report.items():
            log(f"  {name}: {entry['flops']:.4e} FLOPs, "
                f"{entry['bytes_accessed']:.4e} bytes (unfused bound), "
                f"intensity {entry['arithmetic_intensity']:.2f}, roofline "
                f"{entry['roofline']}, peak "
                f"{entry['peak_hbm_bytes'] / 2**30:.2f} GiB"
                + (f", decode MFU {100 * entry['achieved_mfu']:.3f}%"
                   if "achieved_mfu" in entry else ""))
        base_url = f"http://127.0.0.1:{srv.port}"
        code, metrics = _http(base_url + "/metrics")
        families = ("m2kt_serve_roofline_bound", "m2kt_serve_step_flops",
                    "m2kt_serve_hbm_peak_bytes", "m2kt_serve_mfu")
        missing = [f for f in families if f"# TYPE {f} gauge" not in metrics]
        bounds = {name: _metric(metrics, "m2kt_serve_roofline_bound"
                                f'{{executable="{name}"}}')
                  for name in report}
        classes = {1.0: "compute", 0.0: "bandwidth", -1.0: "unknown"}
        traces = json.loads(_http(base_url + "/traces")[1])
        usage = json.loads(_http(base_url + "/usage")[1])
        ready = _http(base_url + "/readyz")
        if (code != 200 or missing or any(
                classes[bounds[n]] != e["roofline"]
                for n, e in report.items())
                or not traces["spans"] or not usage["snapshots"]
                or ready != (200, "serving\n")):
            raise RuntimeError(
                f"obs serve: scrape: /metrics {code}, missing {missing}, "
                f"bounds {bounds}, {len(traces['spans'])} spans, "
                f"{len(usage['snapshots'])} usage snapshots, /readyz "
                f"{ready}")
        log(f"obs serve: /metrics carries {list(families)}; roofline by "
            f"executable {[(n, classes[v]) for n, v in bounds.items()]}; "
            f"/traces {len(traces['spans'])} spans; /usage "
            f"{len(usage['snapshots'])} snapshot(s), tenants "
            f"{sorted(usage['snapshots'][-1]['tenants'])}; /readyz "
            f"{ready[1].strip()}")
        t0 = time.perf_counter()
        code, body = _http(base_url + "/profile?seconds=1")
        written = glob.glob(os.path.join(profile_dir, "*.json"))
        if code != 200 or len(written) != 1:
            raise RuntimeError(f"obs serve: /profile {code} {body} wrote "
                               f"{written}")
        log(f"obs serve: /profile?seconds=1 answered in "
            f"{time.perf_counter() - t0:.2f} s and wrote "
            f"{os.path.basename(written[0])} "
            f"({os.path.getsize(written[0])} bytes)")
    finally:
        srv.close()
        srv._thread.join(30)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg8 = dataclasses.replace(llama_8b(), num_layers=2, attn_impl="flash")
    small = init_llama(cfg8, seed=SEED, device="cuda").eval()
    eng = ServingEngine(small, dataclasses.replace(econf, quant="int8-kv"),
                        device="cuda", tracer=SpanRecorder())
    del small
    reset_launch_counts()
    report8 = eng.cost_report()
    torch.cuda.synchronize()
    int8_launches = {k.name: k.launches for k in KERNELS}
    want = {k.name: 0 for k in KERNELS}
    want["flash_fwd"] = cfg8.num_layers * len(eng.buckets)
    want["paged_decode_int8"] = cfg8.num_layers
    if int8_launches != want or not report8["decode"]["flops"]:
        raise RuntimeError(f"obs serve: int8-kv cost_report launches "
                           f"{int8_launches}, expected {want}")
    dec = report8["decode"]
    log(f"obs serve: int8-kv engine, llama_8b widths, 2 layers: "
        f"cost_report() launched {int8_launches}; decode "
        f"{dec['flops']:.4e} FLOPs, {dec['bytes_accessed']:.4e} bytes, "
        f"roofline {dec['roofline']} (no decode ran: no MFU); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, int8_launches


@contextlib.contextmanager
def _attention_impl(cfg, impl: str):
    """``cfg`` with its attention on the kernels (``"flash"``) or on the
    plain dense path (``"dense"``). Llama has a dense ``attn_impl``;
    GPT-2 has none (its blocks call ``flash_attention`` through the Llama
    module's dispatch, ``llama.causal_attention``), so for it the plain
    version, ``reference_attention``, is swapped in there for the
    duration: the dense side of a parity check."""
    from move2kube_tpu_torch import GPT2Config
    from move2kube_tpu_torch.models import llama
    from move2kube_tpu_torch.ops.attention import reference_attention

    if not isinstance(cfg, GPT2Config):
        yield dataclasses.replace(cfg, attn_impl=impl)
        return
    saved = llama.flash_attention
    if impl == "dense":
        llama.flash_attention = lambda q, k, v, causal: reference_attention(
            q, k, v, causal, q.shape[-1] ** -0.5)
    try:
        yield cfg
    finally:
        llama.flash_attention = saved


def gpt2_kernels_phase(torch) -> dict:
    """Every kernel at GPT-2 small's attention (MHA: h = kvh = 12, d = 64),
    the shapes its slices give them: the flash forward at a 1024-token
    prefill, paged decode over fp and int8 pools at the decode batch of 8
    with lengths up to n_positions (1024), and the backward kernels (and
    the forward with lse) at the training slice's batch of 8 x 1024.
    Checked by the same rules as the Llama shapes, timed beside the plain
    versions and SDPA, with their bounds."""
    return {"flash_fwd": flash_phase(torch, h=12, kvh=12, d=64,
                                     lengths=(1024,))[0],
            "paged_decode": paged_phase(torch, h=12, kvh=12, d=64,
                                        max_seq=1024),
            "paged_decode_int8": paged_int8_phase(torch, h=12, kvh=12, d=64,
                                                  max_seq=1024),
            "bwd": bwd_phase(torch, b=8, s=1024, h=12, kvh=12, d=64)}


def _quant_rows_gate(ref, got) -> tuple[float, int, list]:
    """``logit_gate`` over each request's agreed greedy prefix and the
    first row after it; ``ref``/``got``: rid -> (tokens, logit rows).
    Returns the worst max-rel error, the rows compared and the agreed
    token counts."""
    from move2kube_tpu_torch import logit_gate

    worst, rows, agreed = 0.0, 0, []
    for rid, (a_t, a_rows) in ref.items():
        b_t, b_rows = got[rid]
        agree = _greedy_prefix(a_t, b_t)
        agreed.append(agree)
        for i in range(min(agree + 1, len(a_rows), len(b_rows))):
            worst = max(worst, logit_gate(a_rows[i],
                                          b_rows[i])["max_rel_err"])
            rows += 1
    return worst, rows, agreed


def gpt2_parity_phase(torch) -> None:
    """GPT-2 small's widths at 2 layers in fp32 (seed-0 weights from
    ``init_gpt2``), 8 prompts: the flash engine against plain greedy full
    forwards (the plain attention swapped in), streams identical and
    logits within FP32_ENGINE_ATOL; the int8-kv engine with the prefix
    cache on prompts that share prefixes, held by the quant gate against
    the fp32 engine; spec decode (k=3, a 1-layer draft), streams equal to
    plain greedy; one LoRA row beside base rows, its stream equal to the
    plain forward's with the adapter's delta."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        gpt2_small,
        init_gpt2,
    )

    cfg = dataclasses.replace(gpt2_small(), num_layers=2,
                              dtype=torch.float32)
    model = init_gpt2(cfg, seed=SEED, device="cuda").eval()
    rng = np.random.default_rng(SEED + 9)
    lengths, n_new = (37, 100, 250, 300, 512, 640, 777, 900), 8
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in lengths]
    base = EngineConfig(max_batch=8, max_seq=1024, block_size=16)

    def reqs(ps, adapters=None):
        return [Request(f"p{i}", p, n_new,
                        adapter=(adapters or {}).get(i, ""))
                for i, p in enumerate(ps)]

    eng = ServingEngine(model, base, device="cuda")
    eng.capture_logits = True
    comps = {c.rid: c for c in eng.run(reqs(prompts))}
    worst = 0.0
    want = {}
    with _attention_impl(cfg, "dense"):
        for i, p in enumerate(prompts):
            want[f"p{i}"], rows = _greedy_dense(torch, model, p, n_new)
            if comps[f"p{i}"].tokens != want[f"p{i}"]:
                raise RuntimeError(f"gpt2 parity: prompt {i} stream "
                                   f"{comps[f'p{i}'].tokens} != plain "
                                   f"{want[f'p{i}']}")
            for j in (0, 1):
                err = float(np.abs(eng.logit_log[f"p{i}"][j]
                                   - rows[j].float().cpu().numpy()).max())
                worst = max(worst, err)
                if err > FP32_ENGINE_ATOL:
                    raise RuntimeError(
                        f"gpt2 parity: prompt {i} logits row {j} max abs "
                        f"err {err} > {FP32_ENGINE_ATOL}")
    log(f"gpt2 parity: gpt2_small widths, 2 layers, fp32, prompts "
        f"{list(lengths)} x {n_new} tokens: streams identical to plain "
        f"greedy, prefill/first-decode logits max abs err {worst:.3e} (tol"
        f" {FP32_ENGINE_ATOL})")
    del eng
    # int8-kv with the prefix cache: 4 more prompts on the first four's
    # prefixes (block-aligned and not), against the fp32 engine
    shared = prompts + [prompts[i][:k] + rng.integers(
        1, cfg.vocab_size, size=9).tolist()
        for i, k in ((1, 96), (3, 250), (5, 512), (7, 800))]
    runs = {}
    for name, econf in (("fp32", base), ("int8-kv", dataclasses.replace(
            base, quant="int8-kv", prefix_cache=True))):
        eng = ServingEngine(model, econf, device="cuda")
        eng.capture_logits = True
        got = eng.run(reqs(shared))
        runs[name] = {c.rid: (c.tokens, eng.logit_log[c.rid]) for c in got}
        hits = eng.stats().get("prefix_hits", 0)
        del eng
    q_worst, q_rows, agreed = _quant_rows_gate(runs["fp32"], runs["int8-kv"])
    if not (q_worst < QUANT_GATE_REL and q_rows >= len(shared) and hits):
        raise RuntimeError(f"gpt2 parity: int8-kv + prefix cache vs fp32 max"
                           f" rel err {q_worst:.4f} over {q_rows} rows (tol "
                           f"{QUANT_GATE_REL}), prefix hits {hits}")
    log(f"gpt2 parity: int8-kv engine with the prefix cache, 12 prompts "
        f"({hits} prefix hits) vs the fp32 engine: greedy tokens agreed {agreed} "
        f"of {n_new}, max rel logit err {q_worst:.4f} over {q_rows} rows "
        f"(tol {QUANT_GATE_REL})")
    eng = ServingEngine(model, dataclasses.replace(
        base, spec_k=3, spec_draft_factor=2), device="cuda")
    spec = {c.rid: c.tokens for c in eng.run(reqs(prompts))}
    st = eng.stats()
    del eng
    if spec != want:
        raise RuntimeError(f"gpt2 parity: spec decode streams {spec} != "
                           f"plain greedy {want}")
    log(f"gpt2 parity: spec decode (k=3, a 1-layer draft) streams identical "
        f"to plain greedy; acceptance {st['spec_acceptance_rate']:.3f}, "
        f"{st['passes']['verify']} verify passes")
    # one LoRA row (rank 8) beside base rows, against the plain forward
    # with the same adapter's delta
    gen = np.random.default_rng(SEED + 10)
    a = (gen.normal(size=(cfg.d_model, 8)) * 0.1).astype(np.float32)
    b = (gen.normal(size=(8, cfg.vocab_size)) * 0.1).astype(np.float32)
    eng = ServingEngine(model, dataclasses.replace(
        base, max_loras=1, lora_rank=8), device="cuda")
    eng.register_adapter("x", a, b)
    eng.capture_logits = True
    lora = {c.rid: c for c in eng.run(reqs(prompts[:4], {2: "x"}))}
    stack = (torch.from_numpy(np.stack([np.zeros_like(a), a])).cuda(),
             torch.from_numpy(np.stack([np.zeros_like(b), b])).cuda(),
             torch.tensor([1], device="cuda"))
    with _attention_impl(cfg, "dense"):
        l_want, l_rows = _greedy_dense(torch, model, prompts[2], n_new,
                                       lora=stack)
    l_err = float(np.abs(eng.logit_log["p2"][0]
                         - l_rows[0].float().cpu().numpy()).max())
    del eng
    base_ok = all(lora[f"p{i}"].tokens == want[f"p{i}"] for i in (0, 1, 3))
    if not (lora["p2"].tokens == l_want and base_ok
            and l_err <= FP32_ENGINE_ATOL):
        raise RuntimeError(f"gpt2 parity: LoRA row {lora['p2'].tokens} vs "
                           f"plain {l_want} (first row err {l_err}), base "
                           f"rows equal: {base_ok}")
    log(f"gpt2 parity: a rank-8 LoRA row beside 3 base rows: its stream "
        f"identical to the plain forward's with the adapter's delta on the "
        f"tied head (first logits row max abs err {l_err:.3e}), the base "
        "rows' to plain greedy")
    del model
    torch.cuda.empty_cache()


def gpt2_slice_phase(torch) -> tuple[dict, dict]:
    """GPT-2 small at full width and depth (12 layers, d 768, 12 heads,
    vocab 50257, n_positions 1024; 124 M parameters), bf16, flash,
    ``EngineConfig(max_batch=8, max_seq=1024, block_size=16)``: 16
    requests at once, prompts from seed 2 in 64..768, 64 new tokens; then
    the same under ``quant="int8-kv"``, held to the quant gate against the
    bf16 run. Returns both runs' launch counts."""
    from move2kube_tpu_torch import EngineConfig, gpt2_small, init_gpt2

    cfg = gpt2_small()
    t0 = time.perf_counter()
    model = init_gpt2(cfg, seed=SEED, device="cuda").eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"gpt2 slice: gpt2_small ({n_params / 1e6:.1f} M params), bf16 "
        f"weights drawn on the card in {time.perf_counter() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_seq=1024, block_size=16)
    launches, _, ref = _serve_slice(torch, model, econf, "gpt2 slice",
                                    "paged_decode", max_prompt=768,
                                    keep_logits=True)
    launches8, _, got = _serve_slice(
        torch, model, dataclasses.replace(econf, quant="int8-kv"),
        "gpt2 int8-kv slice", "paged_decode_int8", max_prompt=768,
        keep_logits=True)
    worst, rows, agreed = _quant_rows_gate(ref, got)
    if not (worst < QUANT_GATE_REL and rows >= len(ref)):
        raise RuntimeError(f"gpt2 int8-kv slice: max rel err {worst:.4f} "
                           f"over {rows} rows (tol {QUANT_GATE_REL})")
    log(f"gpt2 int8-kv slice vs the bf16 slice: greedy tokens agreed "
        f"{sorted(agreed)} of 64, max rel logit err {worst:.4f} over {rows}"
        f" rows (tol {QUANT_GATE_REL})")
    del model, ref, got
    torch.cuda.empty_cache()
    return launches, launches8


def gpt2_train_phase(torch) -> dict:
    """GPT-2 small at full depth: fp32 masters, the bf16 policy, AdamW,
    remat, the head-folded chunked loss over the tied head, batch 8 x 1024
    from a seed, 5 timed steps whose launches show every layer's forward,
    recompute and backward in the kernels at d=64; then the bf16 training
    parity gate at 2 layers, flash against the plain attention."""
    import numpy as np

    from move2kube_tpu_torch import gpt2_small, pick_chunk, reset_launch_counts
    from move2kube_tpu_torch.ops.attention import KERNELS

    batch, seq, timed = 8, 1024, 5
    cfg = gpt2_small()
    layers = cfg.num_layers
    rng = np.random.default_rng(SEED + 11)
    batches = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (timed + 1, batch, seq))).cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, _, _ = _train_run(torch, cfg, "bf16", batches[:1])
    torch.cuda.synchronize()
    log(f"gpt2 train: gpt2_small, fp32 masters, bf16 policy, AdamW, remat, "
        f"head-folded CE over the tied head in chunks of "
        f"{pick_chunk(cfg.vocab_size, 2048)}; set-up and warm-up step "
        f"{time.perf_counter() - t0:.1f} s")
    losses = []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids in batches[1:]:
        state, loss = step(state, {"input_ids": ids})
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(x) for x in losses]
    want = {"flash_fwd": 2 * layers * timed, "flash_bwd_dq": layers * timed,
            "flash_bwd_dkv": layers * timed, "paged_decode": 0,
            "paged_decode_int8": 0}
    if launches != want or not np.isfinite(losses).all():
        raise RuntimeError(f"gpt2 train: launches {launches}, expected "
                           f"{want}; losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"gpt2 train: {timed} steps of batch {batch} x {seq}: "
        f"{wall / timed * 1e3:.1f} ms/step, {timed * batch * seq / wall:.1f}"
        f" tokens/s, peak memory {peak:.2f} GiB; losses {losses}; launches "
        f"{launches} = {layers} layers x {timed} steps x (forward + remat "
        "recompute, dq, dkv)")
    del state, step
    torch.cuda.empty_cache()
    parity = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (3, 2, 1024))).cuda()
    bf16_train_parity(torch, dataclasses.replace(cfg, num_layers=2), parity,
                      label="gpt2_small widths (d=64 kernels)")
    return launches


def _moe_cfg(layers: int, **kw):
    from move2kube_tpu_torch import llama_8b

    # what the JAX trainer builds for M2KT_MOE_EXPERTS=8 on the Llama-8B
    # config (train_tpu.py): Mixtral-8x7B's widths
    return dataclasses.replace(llama_8b(), num_layers=layers, moe_experts=8,
                               moe_top_k=2, attn_impl="flash", **kw)


def moe_parity_phase(torch) -> None:
    """The MoE Llama at 2 layers in fp32: the engine with the attention in
    the kernels against the same weights on the dense path, at the same
    pass shapes (routing depends on each pass's tokens): streams
    identical, logits within FP32_ENGINE_ATOL."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
    )

    cfg = _moe_cfg(2, dtype=torch.float32)
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    rng = np.random.default_rng(SEED + 12)
    lengths, n_new = (37, 300, 777, 1200), 8
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in lengths]
    econf = EngineConfig(max_batch=4, max_seq=1280, block_size=16)
    runs = {}
    for impl in ("flash", "dense"):
        dense = dataclasses.replace(cfg, attn_impl=impl)
        model.cfg = dense
        for layer in model.layers:
            layer.cfg = dense
        eng = ServingEngine(model, econf, device="cuda")
        eng.capture_logits = True
        runs[impl] = {c.rid: (c.tokens, eng.logit_log[c.rid])
                      for c in eng.run([Request(f"p{i}", p, n_new)
                                        for i, p in enumerate(prompts)])}
        del eng
    worst = 0.0
    for rid, (toks, rows) in runs["flash"].items():
        d_toks, d_rows = runs["dense"][rid]
        if toks != d_toks:
            raise RuntimeError(f"moe parity: {rid} stream {toks} != dense "
                               f"{d_toks}")
        for a, b in zip(rows, d_rows):
            worst = max(worst, float(np.abs(a - b).max()))
    if worst > FP32_ENGINE_ATOL:
        raise RuntimeError(f"moe parity: logits max abs err {worst} > "
                           f"{FP32_ENGINE_ATOL}")
    log(f"moe parity: llama_8b + 8 experts top-2, 2 layers, fp32, prompts "
        f"{list(lengths)} x {n_new} tokens: the engine on the kernels and "
        f"on dense attention stream identical tokens, every logits row "
        f"within {worst:.3e} (tol {FP32_ENGINE_ATOL})")
    del model
    torch.cuda.empty_cache()


def moe_slice_phase(torch) -> dict:
    """The repo's MoE Llama (``llama_8b()`` with ``moe_experts=8,
    moe_top_k=2``: Mixtral-8x7B's widths) cut to 8 of its 32 layers, bf16,
    flash, ``EngineConfig(max_batch=8, max_seq=2048, block_size=16)``, 16
    requests from seed 2 in 64..1536, 32 new tokens; launches exact. Then
    the same requests on a fresh engine with a hook on each MoE block
    counting the (token, expert) assignments dropped over capacity in
    each pass: its streams equal the timed run's. Returns the timed run's
    launch counts."""
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        MoEMlp,
        Request,
        ServingEngine,
        init_llama,
        top_k_routing,
    )
    from move2kube_tpu_torch.models.moe import capacity_for

    moe_parity_phase(torch)
    cfg = _moe_cfg(8)
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe slice: llama_8b + 8 experts top-2, 8 of 32 layers "
        f"({n_params / 1e9:.3f} B params; 32 layers would hold 46.7 B, 93 "
        f"GB in bf16), bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    launches, _, run = _serve_slice(torch, model, econf, "moe slice",
                                    "paged_decode", n_new=32,
                                    keep_logits=True)
    passes = []  # per MoE call: (tokens, dropped assignments), on device

    def hook(mod, inputs, _out):
        x = inputs[0]
        t = x.shape[0] * x.shape[1]
        cap = capacity_for(t, mod.num_experts, mod.top_k,
                           mod.capacity_factor)
        dispatch, _, _ = top_k_routing(mod.router_logits(x.reshape(t, -1)),
                                       mod.num_experts, mod.top_k, cap)
        passes.append((t, t * mod.top_k - dispatch.sum()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoEMlp)]
    rng = np.random.default_rng(SEED + 2)
    lengths = rng.integers(64, 1537, size=16)
    reqs = [Request(f"r{i}", rng.integers(1, cfg.vocab_size,
                                          size=int(n)).tolist(), 32)
            for i, n in enumerate(lengths)]
    counted = {c.rid: c.tokens for c in ServingEngine(
        model, econf, device="cuda").run(reqs)}
    for h in handles:
        h.remove()
    if counted != {rid: toks for rid, (toks, _) in run.items()}:
        raise RuntimeError("moe slice: the counted run's streams differ "
                           "from the timed run's")
    layers = cfg.num_layers
    per_pass = [(passes[i][0], int(sum(float(d) for _, d in
                                       passes[i:i + layers])))
                for i in range(0, len(passes), layers)]
    prefill = [d for t, d in per_pass if t > econf.max_batch]
    decode = [d for t, d in per_pass if t == econf.max_batch]
    log(f"moe slice: (token, expert) assignments dropped over capacity, "
        f"summed over the 8 layers of each pass: prefills {prefill} (of "
        f"{[t * 2 * layers for t, _ in per_pass if t > econf.max_batch]}); "
        f"{len(decode)} decode passes of 8 rows (capacity 3 an expert, idle"
        f" rows included): {sum(decode)} in all, at most {max(decode)} in "
        f"one, {sum(1 for d in decode if d)} passes with any")
    del model, run
    torch.cuda.empty_cache()
    return launches


def moe_train_phase(torch) -> dict:
    """The MoE Llama's widths at 1 layer (1.71 B parameters; fp32 masters,
    AdamW and grads about 31 GB), the bf16 policy, batch 2 x 2048, 3 timed
    steps. Gates: the step's loss is the LM loss plus 0.01 x the aux loss
    (both recomputed from the same weights and batch before the step),
    and every loss is finite."""
    import numpy as np

    from move2kube_tpu_torch import policy, reset_launch_counts
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.ops.crossentropy import (
        linear_lm_loss,
        lm_head_weight,
    )

    cfg = _moe_cfg(1)
    timed = 3
    rng = np.random.default_rng(SEED + 13)
    batches = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (timed + 1, 2, 2048))).cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, step, _, _ = _train_run(torch, cfg, "bf16", batches[:1])
    torch.cuda.synchronize()
    model = state.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe train: llama_8b + 8 experts top-2, 1 layer "
        f"({n_params / 1e9:.3f} B params, fp32 masters), bf16 policy, AdamW,"
        f" remat; set-up and warm-up step {time.perf_counter() - t0:.1f} s")
    # the loss's parts, from the same weights and the first timed batch
    with torch.no_grad():
        params = policy("bf16").cast_params(dict(model.named_parameters()))
        hidden = torch.func.functional_call(
            model, params, (batches[1],), {"return_hidden": True})
        aux = float(model.moe_aux)
        model.moe_aux = None
        lm = float(linear_lm_loss(hidden, lm_head_weight(params),
                                  batches[1]))
        del hidden, params
    losses = []
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids in batches[1:]:
        state, loss = step(state, {"input_ids": ids})
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    losses = [float(x) for x in losses]
    gap = abs(losses[0] - (lm + 0.01 * aux))
    if not (np.isfinite(losses).all() and aux > 0
            and gap < 0.1 * 0.01 * aux):
        raise RuntimeError(f"moe train: first loss {losses[0]} vs LM loss "
                           f"{lm} + 0.01 x aux {aux} (gap {gap}); losses "
                           f"{losses}")
    if launches["flash_bwd_dq"] != timed or launches["flash_fwd"] != (
            2 * timed):
        raise RuntimeError(f"moe train: launches {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"moe train: {timed} steps of batch 2 x 2048: "
        f"{wall / timed * 1e3:.1f} ms/step, {timed * 4096 / wall:.1f} "
        f"tokens/s, peak memory {peak:.2f} GiB; losses {losses}; the first "
        f"is the LM loss {lm:.6f} + 0.01 x aux {aux:.6f} (gap {gap:.2e}); "
        f"launches {launches}")
    del state, step, model
    torch.cuda.empty_cache()
    return launches


def families_phase(torch) -> None:
    """BERT-base, ResNet-50 and the DDPM UNet, each through its own train
    step at its full config in bf16 over fp32 parameters, AdamW, on one
    fixed batch from a seed: a warm-up step, then 5 timed ones. Gate: the
    loss falls over the steps on the repeated batch. BERT takes lr 1e-6:
    from its random init, with no warmup, AdamW's first steps overshoot
    at 1e-5 and above (the JAX package's step does the same), so its
    loss jumps before it falls. None of these families runs a TPU kernel
    in the JAX package, so no kernel of the port runs here: the launch
    counts stay at 0."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        bert_base,
        init_family,
        make_bert_train_step,
        make_classifier_train_step,
        make_diffusion_train_step,
        reset_launch_counts,
        resnet50,
        unet_small,
    )
    from move2kube_tpu_torch.ops.attention import KERNELS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def ints(high, *shape):
        return torch.randint(0, high, shape, device="cuda", generator=gen)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    bert = bert_base()
    seq = bert.max_len
    lens = ints(seq - seq // 4 + 1, 32) + seq // 4  # real tokens a row
    bert_batch = {"input_ids": ints(bert.vocab_size, 32, seq),
                  "attention_mask": (torch.arange(seq, device="cuda")[None]
                                     < lens[:, None]),
                  "label": ints(2, 32)}
    families = (
        ("bert_base", bert, make_bert_train_step(), bert_batch,
         f"batch 32 x {seq}, padded mask (real lengths {seq // 4}..{seq})",
         1e-6),
        ("resnet50", resnet50(), make_classifier_train_step(
            has_batch_stats=True),
         {"input": normal(64, 224, 224, 3), "label": ints(1000, 64)},
         "batch 64 x 224 x 224 x 3", 1e-3),
        ("unet_small", unet_small(), make_diffusion_train_step(),
         {"image": normal(64, 32, 32, 3), "noise": normal(64, 32, 32, 3),
          "t": ints(1000, 64)}, "batch 64 x 32 x 32 x 3", 1e-4),
    )
    log("families: BERT, ResNet-50 and the UNet run no TPU kernel in the "
        "JAX package (plain einsums and convolutions), so none of the "
        "port's kernels runs here")
    for name, cfg, step, batch, shape, lr in families:
        model = init_family(cfg, seed=SEED, device="cuda")
        n_params = sum(p.numel() for p in model.parameters())
        state = TrainState(model, adamw(model.parameters(), lr, 0.01))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, first = step(state, batch)
        losses = [float(first)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            state, loss = step(state, batch)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        launched = {k.name: k.launches for k in KERNELS if k.launches}
        if not (losses[-1] < losses[0] and all(
                x == x and abs(x) != float("inf") for x in losses)
                and not launched):
            raise RuntimeError(f"families: {name} losses {losses} (must "
                               f"fall), kernel launches {launched}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"families: {name} ({n_params / 1e6:.1f} M params, fp32, bf16 "
            f"compute), {shape}, AdamW lr {lr}: {wall / 5 * 1e3:.1f} "
            f"ms/step over 5 steps after a warm-up, peak memory {peak:.2f} "
            f"GiB; losses {[round(x, 5) for x in losses]}")
        del state, model
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the resilience phase: build cache, a killed trainer resumed under the
# port's supervisor, bit-for-bit against an uninterrupted run, and the
# checkpoint served

# the trainer of the killed run: Llama-8B widths cut to 2 layers (about
# 0.70 B parameters), fp32 masters, the bf16 policy, AdamW, flash and remat
RES_LAYERS, RES_BATCH, RES_SEQ, RES_ROWS = 2, 4, 2048, 64
RES_STEPS, RES_EVERY, RES_FAULT_STEP, RES_KEEP = 8, 2, 5, 2
RES_LR, RES_WD = 1e-4, 0.1
RES_CHILD_TIMEOUT_S = 420


def _res_cfg(layers: int = RES_LAYERS):
    from move2kube_tpu_torch import llama_8b

    return dataclasses.replace(llama_8b(), num_layers=layers,
                               attn_impl="flash")


def _res_bytes_estimate(cfg) -> int:
    """A checkpoint's bytes: every parameter in fp32 and its two Adam
    moments (12 bytes a parameter)."""
    hd = cfg.d_model // cfg.num_heads
    layer = (2 * cfg.d_model * cfg.num_heads * hd
             + 2 * cfg.d_model * cfg.num_kv_heads * hd
             + 3 * cfg.d_model * cfg.mlp_dim + 2 * cfg.d_model)
    n = 2 * cfg.vocab_size * cfg.d_model + cfg.num_layers * layer \
        + cfg.d_model
    return 12 * n


def _digest_state(state) -> dict:
    """SHA-256 of every parameter's and Adam moment's bytes, by name (the
    tensors are copied to the host and hashed on 8 threads: hashlib
    releases the GIL)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    named = {}
    inner = state.optimizer.inner
    for name, p in state.model.named_parameters():
        named[f"param/{name}"] = p
        for key in ("exp_avg", "exp_avg_sq"):
            named[f"{key}/{name}"] = inner.state[p][key]

    def sha(t):
        host = t.detach().contiguous().cpu().view(torch.uint8).numpy()
        return hashlib.sha256(memoryview(host)).hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(zip(named, pool.map(sha, named.values())))


def resilience_child() -> int:
    """The trainer the resilience phase runs (``--resilience-child``), in
    the emitted trainer's order (``train_tpu.py:545-713``): the loader,
    the checkpoint manager and its exit flush, ``restore_or_init`` and
    the loader's skip, then each step's fault check, step, save and
    preemption check, then the goodput flush. Deterministic algorithms
    (``CUBLAS_WORKSPACE_CONFIG`` comes from the parent). Prints each
    step's loss bits and kernel launches, each save's seconds; with
    ``M2KT_DIGEST_FILE`` it writes the final parameters' and moments'
    SHA-256, with ``M2KT_FINAL_MODEL`` the final model's state dict."""
    import torch

    if not torch.cuda.is_available():
        print("resilience child: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_llama,
        make_lm_train_step,
        make_loader,
        policy,
        reset_launch_counts,
        setup_compilation_cache,
    )
    from move2kube_tpu_torch.models import checkpoint as m2kt_ckpt
    from move2kube_tpu_torch.obs import tracing
    from move2kube_tpu_torch.ops import _build
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.resilience import faults, goodput, preemption

    cache = setup_compilation_cache()
    if tracing.enabled():
        tracing.install_ring_flush()
    gp = goodput.GoodputTracker()
    watcher = preemption.from_env()
    if watcher is not None:
        watcher.install()
    steps = int(os.environ.get("M2KT_STEPS", str(RES_STEPS)))
    cfg = _res_cfg()
    pol = policy("bf16")
    model = init_llama(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    state = TrainState(model, pol.wrap_optimizer(adamw(
        model.parameters(), RES_LR, weight_decay=RES_WD)))
    step_fn = make_lm_train_step(remat=True, precision=pol)
    loader = make_loader(os.environ["M2KT_DATA"], RES_BATCH, device="cuda",
                         seed=SEED)
    ckpt = m2kt_ckpt.from_env()
    start = 0
    if ckpt is not None:
        ckpt.max_to_keep = RES_KEEP
        ckpt.install_exit_flush()
        t0 = time.perf_counter()
        with gp.phase("restore"):
            state, start = ckpt.restore_or_init(state)
            torch.cuda.synchronize()
        if start:
            gp.note_resume(start)
            gp.note_saved(start)
            print(f"[m2kt] resumed from step {start}", flush=True)
            print(f"[m2kt] restore {time.perf_counter() - t0:.3f} s "
                  f"({ckpt.restored['bytes'] / 1e9:.3f} GB)", flush=True)
    if start:
        loader.skip(start)
        cursor = ckpt.restored["loader"]
        if loader.position() != cursor:
            raise RuntimeError(f"the loader skipped to {loader.position()}"
                               f", the checkpoint's cursor is {cursor}")
        print(f"[m2kt] skipped {start} batches (the checkpoint's cursor "
              f"{cursor})", flush=True)
    print(f"[m2kt] build dir {cache}; nvcc runs {_build.nvcc_runs}",
          flush=True)
    reset_launch_counts()
    preempted_at = None
    with loader:
        for i in range(start + 1, steps + 1):
            faults.maybe_inject(i)
            t0 = time.perf_counter()
            state, loss = step_fn(state, next(loader))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            gp.add("compile" if i == start + 1 else "productive", dt,
                   steps=1)
            launches = {k.name: k.launches for k in KERNELS}
            print(f"[m2kt] step {i} loss {float(loss).hex()} "
                  f"{dt * 1e3:.1f} ms launches {json.dumps(launches)}",
                  flush=True)
            if ckpt is not None and ckpt.maybe_save(i, state, loader=loader):
                ckpt.wait()  # M2KT_CKPT_SYNC=1 already waited
                gp.note_saved(i)
                gp.write()
                done = ckpt.last_save
                print(f"[m2kt] save step {i}: {done['bytes'] / 1e9:.3f} GB, "
                      f"host copy {done['snapshot_seconds']:.3f} s, write "
                      f"{done['seconds']:.3f} s "
                      f"({done['bytes'] / 1e9 / done['seconds']:.3f} GB/s)",
                      flush=True)
            if watcher is not None and watcher.should_stop(i):
                preempted_at = i
                break
    last = preempted_at if preempted_at is not None else steps
    if ckpt is not None:
        with gp.phase("save"):
            ckpt.maybe_save(last, state, force=True, loader=loader)
            ckpt.close()
        gp.note_saved(last)
    gp.write()
    if os.environ.get("M2KT_DIGEST_FILE"):
        with open(os.environ["M2KT_DIGEST_FILE"], "w",
                  encoding="utf-8") as f:
            json.dump(_digest_state(state), f)
    if os.environ.get("M2KT_FINAL_MODEL"):
        torch.save(state.model.state_dict(), os.environ["M2KT_FINAL_MODEL"])
    rep = gp.report()
    print(f"[m2kt] done steps={last} goodput={rep['goodput_fraction']:.4f}",
          flush=True)
    return 143 if preempted_at is not None else 0


def _child_steps(out: str) -> list:
    """Each ``[m2kt] step`` line of a child's output: (step, loss bits,
    ms, launches), in order."""
    rows = []
    for line in out.splitlines():
        if line.startswith("[m2kt] step ") and " launches " in line:
            head, launches = line.split(" launches ", 1)
            parts = head.split()
            rows.append((int(parts[2]), parts[4], float(parts[5]),
                         json.loads(launches)))
    return rows


def _attempts(out: str) -> list:
    """A supervised run's output cut into its attempts' step rows (each
    child prints its build directory before its first step)."""
    runs = []
    for line in out.splitlines():
        if line.startswith("[m2kt] build dir "):
            runs.append([])
        elif runs:
            runs[-1].extend(_child_steps(line))
    return runs


def _want_train_launches(n_steps: int, layers: int = RES_LAYERS) -> dict:
    return {"flash_fwd": 2 * layers * n_steps,
            "flash_bwd_dq": layers * n_steps,
            "flash_bwd_dkv": layers * n_steps,
            "paged_decode": 0, "paged_decode_int8": 0}


def _res_workdir(need: int) -> str:
    """A directory for the checkpoints: the temporary directory, or the
    checkout's ignored ``build/`` when that has more room; fails loudly
    when neither holds ``need`` bytes."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    cands = [tempfile.gettempdir(), os.path.join(here, "build")]
    os.makedirs(cands[1], exist_ok=True)
    free = {c: shutil.disk_usage(c).free for c in cands}
    for c, f in free.items():
        log(f"resilience: {f / 1e9:.1f} GB free under {c}")
    best = max(cands, key=free.get)
    if free[best] < need:
        raise RuntimeError(
            f"resilience: the checkpoints need {need / 1e9:.1f} GB of disk;"
            f" the most free is {free[best] / 1e9:.1f} GB under {best}")
    return tempfile.mkdtemp(prefix="m2kt-resilience-", dir=best)


def _build_cache_check(work: str) -> None:
    """The resilience phase's build cache: ``bake_prewarm`` builds every
    kernel cold (one nvcc each) into a prewarm artifact under ``work``;
    then ``setup_compilation_cache`` on an empty directory seeded from it
    (``M2KT_PREWARM_DIR``) and fresh kernel objects load all five with no
    nvcc. The build directory and the env are put back."""
    from move2kube_tpu_torch import bake_prewarm, setup_compilation_cache
    from move2kube_tpu_torch.ops import _build
    from move2kube_tpu_torch.ops.attention import KERNELS

    prev_dir = _build.set_build_dir(None)
    env_prev = os.environ.get("M2KT_PREWARM_DIR")
    try:
        runs0 = _build.nvcc_runs
        t0 = time.perf_counter()
        baked = bake_prewarm(os.path.join(work, "prewarm"))
        cold = time.perf_counter() - t0
        if baked != 2 * len(KERNELS) or \
                _build.nvcc_runs - runs0 != len(KERNELS):
            raise RuntimeError(
                f"resilience: the cold bake left {baked} files after "
                f"{_build.nvcc_runs - runs0} nvcc runs")
        os.environ["M2KT_PREWARM_DIR"] = os.path.join(work, "prewarm")
        t0 = time.perf_counter()
        cache = setup_compilation_cache(os.path.join(work, "cache"))
        fresh = [_build.CudaKernel(k.name, k.symbol, k.argtypes)
                 for k in KERNELS]
        runs1 = _build.nvcc_runs
        _build.build_all(fresh)
        seeded = time.perf_counter() - t0
    finally:
        _build.set_build_dir(prev_dir)
        if env_prev is None:
            os.environ.pop("M2KT_PREWARM_DIR", None)
        else:
            os.environ["M2KT_PREWARM_DIR"] = env_prev
    if _build.nvcc_runs != runs1:
        raise RuntimeError("resilience: the seeded build ran nvcc")
    log(f"resilience: build cache: cold bake of {len(KERNELS)} kernels "
        f"({len(KERNELS)} nvcc runs) {cold:.3f} s; an empty cache seeded "
        f"from it loaded all {len(fresh)} in {seeded:.3f} s with 0 nvcc "
        f"runs ({cache}) ({CARD})")


def resilience_phase(torch) -> dict:
    """(a) the build cache (:func:`_build_cache_check`), while (b) the
    killed trainer: ``python -m move2kube_tpu_torch.resilience.
    supervisor -- python chip_smoke.py --resilience-child`` over an npz of
    token ids, SIGKILLed at step 5, resumed from step 4; (c) beside it an
    uninterrupted child of the same 8 steps; the final parameters and
    Adam moments equal bit for bit (SHA-256 of each tensor's bytes);
    (d) the final checkpoint through ``restore_variables`` into a bf16
    Llama served to 4 requests, streams equal to the uninterrupted
    trainer's final state dict served the same way; (e) the numbers.
    Returns the main-path launches of the children and the engines."""
    import shutil

    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Llama,
        Request,
        restore_variables,
    )
    from move2kube_tpu_torch.ops.attention import KERNELS

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _res_cfg()
    need = _res_bytes_estimate(cfg)
    work = _res_workdir((RES_KEEP + 1) * need + (4 << 30))
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        # the data: token ids from SEED
        rng = np.random.default_rng(SEED + 11)
        data = os.path.join(work, "tokens.npz")
        np.savez(data, input_ids=rng.integers(
            0, cfg.vocab_size, (RES_ROWS, RES_SEQ), dtype=np.int64))
        base = {k: v for k, v in os.environ.items()
                if not k.startswith("M2KT_")}
        base.update({
            "PYTHONPATH": here, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
            "M2KT_DATA": data, "M2KT_STEPS": str(RES_STEPS),
            "M2KT_COMPILE_CACHE": "0",
            "M2KT_PREEMPT_FILE": os.path.join(work, "preempt")})
        child = [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--resilience-child"]
        killed = dict(
            base, M2KT_CKPT_DIR=os.path.join(work, "ckpt"),
            M2KT_CKPT_EVERY=str(RES_EVERY), M2KT_CKPT_SYNC="1",
            M2KT_FAULT_STEP=str(RES_FAULT_STEP), M2KT_FAULT_KIND="sigkill",
            M2KT_FAULT_MARKER=os.path.join(work, "fault-fired"),
            M2KT_RETRY_MAX="1", M2KT_RETRY_BACKOFF_S="0.1",
            M2KT_EXIT_FILE=os.path.join(work, "exit.json"),
            M2KT_GOODPUT_FILE=os.path.join(work, "goodput.json"),
            M2KT_FLIGHT_PATH=os.path.join(work, "flight.json"),
            M2KT_DIGEST_FILE=os.path.join(work, "digest-resumed.json"))
        straight = dict(
            base, M2KT_GOODPUT_FILE=os.path.join(work, "goodput-u.json"),
            M2KT_FLIGHT_PATH=os.path.join(work, "flight-u.json"),
            M2KT_DIGEST_FILE=os.path.join(work, "digest-straight.json"),
            M2KT_FINAL_MODEL=os.path.join(work, "final-model.pt"))
        log(f"resilience: llama_8b widths, {RES_LAYERS} layers, fp32 "
            f"masters, bf16 policy, AdamW, flash, remat, batch {RES_BATCH} x"
            f" {RES_SEQ}, {RES_STEPS} steps, checkpoint every {RES_EVERY} "
            f"(sync, {RES_KEEP} kept, about {need / 1e9:.2f} GB each), "
            f"SIGKILL at step {RES_FAULT_STEP}; deterministic algorithms")

        # (b) the killed run under the supervisor and (c) the
        # uninterrupted run, side by side on the card (each child holds
        # about 15 GB; both load the kernels the build phase built), and
        # (a) the build cache in this process meanwhile
        lengths = np.random.default_rng(SEED + 12).integers(64, 513, 4)
        reqs = [Request(f"c{i}", np.random.default_rng(SEED + 13 + i)
                        .integers(1, cfg.vocab_size, int(n)).tolist(), 16)
                for i, n in enumerate(lengths)]
        runs, streams, launches = {}, {}, {k.name: 0 for k in KERNELS}

        def serve(label, load):
            """(d): a bf16 Llama of the trainer's widths loaded by
            ``load(state dict)``, serving ``reqs`` on a fresh engine."""
            model = Llama(cfg, device="cuda").eval()
            t0 = time.perf_counter()
            model.load_state_dict(load(model.state_dict()))
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            eng, comps, got, wall = _engine_run(
                torch, model, EngineConfig(max_batch=4, max_seq=1024,
                                           block_size=16),
                reqs, f"resilience {label}")
            streams[label] = {rid: c.tokens for rid, c in comps.items()}
            for name, n in got.items():
                launches[name] += n
            log(f"resilience: served {label} ({t_load:.3f} s to load): 4 "
                f"requests, prompts {sorted(lengths.tolist())}, 16 new tokens"
                f", wall {wall:.3f} s, launches {got} ({CARD})")
            del eng, model
            gc.collect()
            torch.cuda.empty_cache()

        def direct(variables):
            final = torch.load(straight["M2KT_FINAL_MODEL"],
                               map_location="cpu", weights_only=True,
                               mmap=True)
            return {k: final[k].to(device=v.device, dtype=v.dtype)
                    for k, v in variables.items()}

        def finish(name, proc):
            out, err = proc.communicate(timeout=2 * RES_CHILD_TIMEOUT_S)
            runs[name] = (out, time.perf_counter() - t0)
            for line in out.splitlines():
                log(f"  {name}| {line}")
            if proc.returncode != 0:
                raise RuntimeError(f"resilience: the {name} run exited "
                                   f"{proc.returncode}:\n{err[-4000:]}")

        # (b) the killed run under the supervisor and (c) the
        # uninterrupted run, side by side on the card (each child holds
        # about 15 GB; both load the kernels the build phase built); here
        # meanwhile (a) the build cache, then (d)'s direct model once the
        # uninterrupted run is done
        procs = {
            "supervised": subprocess.Popen(
                [sys.executable, "-m",
                 "move2kube_tpu_torch.resilience.supervisor", "--", *child],
                env=killed, cwd=work, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
            "uninterrupted": subprocess.Popen(
                child, env=straight, cwd=work, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)}
        t0 = time.perf_counter()
        try:
            _build_cache_check(work)
            finish("uninterrupted", procs["uninterrupted"])
            serve("direct", direct)
            finish("supervised", procs["supervised"])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        (out, t_sup), (one_out, _) = runs["supervised"], runs["uninterrupted"]
        if f"FAULT: injected sigkill at step {RES_FAULT_STEP}" not in out \
                or f"resumed from step {RES_FAULT_STEP - 1}" not in out:
            raise RuntimeError("resilience: no kill at step "
                               f"{RES_FAULT_STEP} and resume from "
                               f"{RES_FAULT_STEP - 1}")
        summary = json.load(open(os.path.join(work, "exit.json")))
        classes = [a["class"] for a in summary["attempts"]]
        if summary["exit_class"] != "ok" or classes != ["retryable", "ok"]:
            raise RuntimeError(f"resilience: exit {summary['exit_class']}, "
                               f"attempts {classes}")
        attempts = _attempts(out)
        straight_rows = _child_steps(one_out)
        want_steps = [list(range(1, RES_FAULT_STEP)),
                      list(range(RES_FAULT_STEP, RES_STEPS + 1))]
        if [[r[0] for r in a] for a in attempts] != want_steps or \
                [r[0] for r in straight_rows] != list(
                    range(1, RES_STEPS + 1)):
            raise RuntimeError("resilience: the steps each run took differ "
                               "from the plan")
        for rows in (*attempts, straight_rows):
            got = rows[-1][3]
            want = _want_train_launches(len(rows))
            _check_launches(f"resilience child, steps {rows[0][0]}-"
                            f"{rows[-1][0]}", got, want)
            for name, n in got.items():
                launches[name] += n
        if out.count("nvcc runs 0") != 2 or "nvcc runs 0" not in one_out:
            raise RuntimeError("resilience: a child ran nvcc")

        # (c) the bits
        bits_killed = [r[1] for a in attempts for r in a]
        bits_one = [r[1] for r in straight_rows]
        if bits_killed != bits_one:
            raise RuntimeError(f"resilience: losses {bits_killed} against "
                               f"the uninterrupted run's {bits_one}")
        da = json.load(open(killed["M2KT_DIGEST_FILE"]))
        db = json.load(open(straight["M2KT_DIGEST_FILE"]))
        differ = sorted(k for k in db if da.get(k) != db[k])
        if set(da) != set(db) or differ:
            raise RuntimeError(f"resilience: {len(differ)} of {len(db)} "
                               f"tensors differ from the uninterrupted run's"
                               f": {differ[:6]}")
        log(f"resilience: bit for bit: the resumed run's {len(db)} final "
            f"tensors (parameters, Adam's exp_avg and exp_avg_sq) have the"
            f" SHA-256 of the uninterrupted run's, and its 8 losses the "
            f"same bits ({bits_one[-1]} at step {RES_STEPS})")

        # (e) the numbers
        for a in summary["attempts"]:
            rep = a.get("report") or {}
            log(f"resilience: attempt {a['attempt']}: rc {a['returncode']} "
                f"class {a['class']}, wall {a['wall_seconds']} s, goodput "
                f"fraction {rep.get('goodput_fraction')}, seconds "
                f"{rep.get('seconds')} ({CARD})")
        merged = summary["goodput"]
        log(f"resilience: supervised run {t_sup:.1f} s (the uninterrupted "
            f"run beside it); merged goodput fraction "
            f"{merged['goodput_fraction']} over {merged['wall_seconds']} s, "
            f"seconds {merged['seconds']} ({CARD})")
        log("resilience: exit file " + json.dumps(
            {k: summary[k] for k in ("exit_class", "returncode")}
            | {"attempts": [{k: a[k] for k in ("attempt", "returncode",
                                               "class", "wall_seconds")}
                            for a in summary["attempts"]]}))
        flight = json.load(open(killed["M2KT_FLIGHT_PATH"]))
        log(f"resilience: flight doc keys {sorted(flight)}; exit_class "
            f"{flight['exit_class']}, returncode {flight['returncode']}, "
            f"{len(flight['spans'])} spans, numerics {flight['numerics']}")
        if flight["exit_class"] != "retryable" or flight["numerics"]:
            raise RuntimeError(f"resilience: flight doc {flight['exit_class']}"
                               f" numerics {flight['numerics']}")

        # (d) served from the checkpoint
        serve("restored", lambda variables: restore_variables(
            killed["M2KT_CKPT_DIR"], variables))
        if streams["restored"] != streams["direct"]:
            raise RuntimeError(f"resilience: restored streams "
                               f"{streams['restored']} != direct "
                               f"{streams['direct']}")
        log(f"resilience: the checkpoint's streams equal the trainer's "
            f"final state dict's: {streams['restored']['c0']}")
        log(f"resilience: phase {time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------------
# the emission phase: the port's emitter renders a Llama trainer's and a
# Llama server's payload; the emitted programs run from them as an image
# would run them

# the trainer: Llama-8B widths cut to 2 layers (a full-depth training
# state does not fit one card), the bf16 policy, batch 4 x 2048, 10 steps,
# a checkpoint every 5; the HF weights it starts from are drawn from
# numpy seed 13
EMIT_LAYERS, EMIT_BATCH, EMIT_SEQ, EMIT_STEPS, EMIT_EVERY = 2, 4, 2048, 10, 5
EMIT_HF_SEED, EMIT_HF_STD = 13, 0.02
EMIT_LR, EMIT_WD = 3e-4, 0.1
EMIT_CHILD_TIMEOUT_S = 420
# the served requests: 4 prompts from seed 2, 64..512 tokens, 16 new
# tokens each (the second streamed), and one whose deadline cannot be met
EMIT_PROMPT_SEED, EMIT_NEW = 2, 16
# the emitted server's anomaly watchdog checks its triggers this often
# (``serve_gpu.py``'s diagnostic loop)
EMIT_DIAG_PERIOD_S = 5.0
DETERMINISTIC_PRELUDE = (
    "import runpy, torch; torch.use_deterministic_algorithms(True); "
    "torch.backends.cuda.matmul.allow_tf32 = False; "
    "torch.backends.cudnn.allow_tf32 = False; "
    "runpy.run_path('train_gpu.py', run_name='__main__')")


def emit_services(root: str) -> dict:
    """Stand-ins for the JAX planner's services of
    ``samples/gpu-training/llama3-8b`` (training), ``llama-serve``
    (serving) and ``gpt2`` (data-parallel training), with the attributes
    the port's emitter reads; ``root`` is the checkout (the planner's
    paths are absolute)."""
    from types import SimpleNamespace

    def service(name, entry, family="llama", **acc):
        src = os.path.join(root, "samples", "gpu-training", name)
        return SimpleNamespace(
            service_name=name, image="",
            containerization_target_options=[family],
            source_artifacts={"SourceDirectories": [src]},
            accelerator=SimpleNamespace(
                gpu_vendor="nvidia.com/gpu", model_family=family,
                entrypoint=os.path.join(src, entry), **acc))

    return {
        "train": service(
            "llama3-8b", "train_llama3.py", gpu_count=64,
            frameworks=["deepspeed", "torch"], distributed_backend="nccl",
            parallelism={"zero_stage": 3, "dp": 64}, num_hosts=16,
            num_slices=1, serving=False, serving_port=0,
            tpu_topology="4x4x4"),
        "serve": service(
            "llama-serve", "serve.py", gpu_count=1, frameworks=["torch"],
            distributed_backend="", parallelism={}, num_hosts=1,
            num_slices=1, serving=True, serving_port=8000),
        # samples/gpu-training/gpt2: torchrun on 8 GPUs, a data=8 mesh
        "gpt2": service(
            "gpt2", "finetune_gpt2.py", gpu_count=8, frameworks=["torch"],
            distributed_backend="nccl", parallelism={"dp": 8}, num_hosts=2,
            num_slices=1, serving=False, serving_port=0,
            tpu_topology="2x4", tpu_accelerator="tpu-v5-lite-podslice",
            family="gpt")}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hf_llama(cfg, path: str) -> None:
    """An HF-layout ``LlamaForCausalLM`` state dict of ``cfg``'s widths,
    drawn on the card from a generator seeded with EMIT_HF_SEED, saved as
    ``path``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(EMIT_HF_SEED)
    hd = cfg.d_model // cfg.num_heads

    def draw(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * EMIT_HF_STD).cpu()

    sd = {"model.embed_tokens.weight": draw(cfg.vocab_size, cfg.d_model),
          "model.norm.weight": torch.ones(cfg.d_model),
          "lm_head.weight": draw(cfg.vocab_size, cfg.d_model)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for name, shape in (
                ("self_attn.q_proj", (cfg.num_heads * hd, cfg.d_model)),
                ("self_attn.k_proj", (cfg.num_kv_heads * hd, cfg.d_model)),
                ("self_attn.v_proj", (cfg.num_kv_heads * hd, cfg.d_model)),
                ("self_attn.o_proj", (cfg.d_model, cfg.num_heads * hd)),
                ("mlp.gate_proj", (cfg.mlp_dim, cfg.d_model)),
                ("mlp.up_proj", (cfg.mlp_dim, cfg.d_model)),
                ("mlp.down_proj", (cfg.d_model, cfg.mlp_dim))):
            sd[p + name + ".weight"] = draw(*shape)
        sd[p + "input_layernorm.weight"] = torch.ones(cfg.d_model)
        sd[p + "post_attention_layernorm.weight"] = torch.ones(cfg.d_model)
    torch.save(sd, path)


def _digest_tree(model_sd: dict, opt_sd: dict, names: list) -> dict:
    """SHA-256 of every parameter's and Adam moment's bytes, by name:
    ``model_sd`` a state dict, ``opt_sd`` a torch optimizer's state dict
    whose parameter indices follow ``names``."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    named = {f"param/{n}": model_sd[n] for n in names}
    for idx, n in enumerate(names):
        for key in ("exp_avg", "exp_avg_sq"):
            named[f"{key}/{n}"] = opt_sd["state"][idx][key]

    def sha(t):
        host = t.detach().contiguous().cpu().view(torch.uint8).numpy()
        return hashlib.sha256(memoryview(host)).hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(zip(named, pool.map(sha, named.values())))


class _Child:
    """An emitted program in a child process, its output collected line by
    line (each echoed with ``label``)."""

    def __init__(self, label, argv, env, cwd):
        import threading

        self.label, self.lines = label, []
        self.proc = subprocess.Popen(argv, env=env, cwd=cwd,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            log(f"  {self.label}| {line.rstrip()}")

    def wait_for(self, prefix: str, timeout: float) -> str:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            hit = next((x for x in self.lines if x.startswith(prefix)), None)
            if hit is not None:
                return hit
            if self.proc.poll() is not None:
                self._reader.join(5)
                raise RuntimeError(f"emit: {self.label} exited "
                                   f"{self.proc.returncode} before {prefix!r}")
            time.sleep(0.2)
        raise RuntimeError(f"emit: {self.label}: no {prefix!r} in {timeout} s")

    def finish(self, timeout: float) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        self._reader.join(10)
        return rc

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _emit_requests(vocab: int):
    import numpy as np

    rng = np.random.default_rng(EMIT_PROMPT_SEED)
    lengths = rng.integers(64, 513, 4)
    return [rng.integers(1, vocab, int(n)).tolist() for n in lengths]


def _serve_child(label, payload, env, prompts, stream_index, deadline):
    """The emitted server in a child: wait for its listener, send the
    prompts one after another (``stream_index`` over SSE) and, with
    ``deadline``, one more request under an X-M2KT-Deadline it cannot
    meet; read ``/stats`` and the metrics port's ``/metrics``, POST
    ``/drain``, SIGTERM it, and require exit 0. Returns (streams, stats,
    metrics text, seconds to /healthz, the prompts' seconds on the
    client's clock, the diagnostic bundles under ``M2KT_DIAG_DIR`` that
    the server captured before the shed request). The shed request's SLO
    burn may rightly be captured, so it is sent only after the watchdog
    has checked its triggers at least once since the listener came up,
    and the bundles are read after the server exited (its captures
    joined), each with its capture time from its manifest; a bundle with
    no manifest counts as captured before."""
    import signal

    t0 = time.perf_counter()
    child = _Child(label, [sys.executable, "serve_gpu.py"], env, payload)
    try:
        line = child.wait_for("[m2kt] serving on :", EMIT_CHILD_TIMEOUT_S)
        # the watchdog starts before the listener
        t_listen = time.time()
        base = f"http://127.0.0.1:{int(line.split(':')[1].split()[0])}"
        code, _ = _http(base + "/healthz")
        t_ready = time.perf_counter() - t0
        if code != 200:
            raise RuntimeError(f"emit: {label} /healthz {code}")
        streams = []
        t_req = time.perf_counter()
        for i, prompt in enumerate(prompts):
            doc = {"prompt": prompt, "max_new_tokens": EMIT_NEW}
            if i == stream_index:
                code, body = _http(base + "/generate",
                                   dict(doc, stream=True))
                events = [json.loads(x[len("data: "):])
                          for x in body.split("\n\n") if x.strip()]
                if events[-1] != {"finish_reason": "length"}:
                    raise RuntimeError(f"emit: {label} SSE ended "
                                       f"{events[-1]}")
                streams.append([e["token"] for e in events[:-1]])
            else:
                code, body = _http(base + "/generate", doc)
                streams.append(json.loads(body)["tokens"])
            if code != 200:
                raise RuntimeError(f"emit: {label} request {i}: {code} "
                                   f"{body[:300]}")
        t_req = time.perf_counter() - t_req
        t_shed = float("inf")
        if deadline:
            time.sleep(max(0.0, t_listen + EMIT_DIAG_PERIOD_S + 1.0
                           - time.time()))
            t_shed = time.time()
            code, body = _http(
                base + "/generate", {"prompt": prompts[0],
                                     "max_new_tokens": EMIT_NEW},
                headers={"X-M2KT-Deadline": "0.001"})
            if code != 504:
                raise RuntimeError(f"emit: {label}: an unmeetable deadline "
                                   f"got {code}, not 504: {body[:300]}")
            log(f"emit: {label}: unmeetable deadline -> 504 ({body})")
        stats = json.loads(_http(base + "/stats")[1])
        metrics = _http(
            f"http://127.0.0.1:{env['M2KT_METRICS_PORT']}/metrics")[1]
        code, body = _http(base + "/drain", {})
        if code != 200 or not json.loads(body)["drained"]:
            raise RuntimeError(f"emit: {label} /drain {code} {body}")
        child.proc.send_signal(signal.SIGTERM)
        rc = child.finish(120)
        if rc != 0:
            raise RuntimeError(f"emit: {label} exited {rc}")
        diag = env.get("M2KT_DIAG_DIR", "")
        early = []
        for name in sorted(os.listdir(diag)) if os.path.isdir(diag) else []:
            manifest = os.path.join(diag, name, "manifest.json")
            at = 0.0
            if os.path.isfile(manifest):
                with open(manifest) as f:
                    at = json.load(f)["captured_unix"]
            if at < t_shed:
                early.append(name)
        return streams, stats, metrics, t_ready, t_req, early
    finally:
        child.stop()


def _traffic(label, stats, layers) -> dict:
    """What a server child's (or an in-process replay's) traffic did:
    ``stats`` is the engine's ``stats()`` after its warm request, which
    reaches none of its counters, with ``launches``, the counts measured
    from then on, which must equal what the traffic's passes imply.
    Returns the passes, the launches, the decode ms a pass (a window
    divided by its passes) and tokens/s, and the mean TTFT of the
    traffic's requests."""
    passes = stats["passes"]
    exp = _expected_launches(stats, layers, 0)
    want = dict.fromkeys(stats["launches"], 0)
    want.update(flash_fwd=exp["flash_fwd"], paged_decode=exp["paged"])
    _check_launches(f"{label} (traffic passes {passes})", stats["launches"],
                    want)
    return {"passes": passes, "launches": stats["launches"],
            "decode_ms": 1e3 * stats["decode_time_s"] / passes["decode"],
            "tokens_s": stats["decode_throughput_tokens_s"],
            "ttft_mean_ms": stats["ttft_mean_ms"]}


def _engine_streams(torch, model, prompts, label, profile=False):
    """The same prompts one after another on a fresh synchronous engine
    after its warm request, as the server child served them: launch
    counts set to 0 after the warm request and held to the replay's
    passes. With ``profile``, one more request's 4 decode steps at 1 of 8
    slots run under the profiler after the replay. Returns (streams,
    :func:`_traffic` of the replay, its seconds, profiled busy ms a
    decode step or None)."""
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.ops.attention import KERNELS

    eng = ServingEngine(model, EngineConfig(
        max_batch=8, max_seq=2048, block_size=16, async_decode="off"),
        device="cuda")
    eng.warm(prompt=[1], max_new_tokens=2)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = [eng.run([Request(f"r{i}", p, EMIT_NEW)])[0].tokens
           for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traffic = _traffic(label, dict(
        eng.stats(), launches={k.name: k.launches for k in KERNELS}),
        model.cfg.num_layers)
    busy = None
    if profile:
        eng.submit(Request("_prof", prompts[0], EMIT_NEW))
        eng.step()  # its prefill and first decode step
        busy = _profiled(torch, f"{label}: 4 decode steps at 1 of 8 slots",
                         lambda: [eng.step() for _ in range(4)]) / 4
        while eng.has_work():
            eng.step()
    return out, traffic, wall, busy


def emit_phase(torch) -> dict:
    """(1) the port's emitter renders the Llama training and serving
    payloads from :func:`emit_services`; (2) the emitted
    ``port_weights.py`` converts an HF Llama state dict (Llama-8B widths,
    2 layers) into the trainer's step-0 checkpoint; (3) the emitted
    trainer runs 10 steps under the port's supervisor (deterministic
    algorithms), and the same 10 steps in this process from the same
    weights and batches end with parameters and Adam moments equal by
    SHA-256; (4) the emitted server at full Llama-8B depth (seed-0 init),
    at its defaults and with windows of 4 passes, serves 4 requests (one
    streamed) and sheds one with a 504, its streams equal to an
    in-process synchronous engine's, its passes what the requests imply
    and no diagnostic bundle captured before the shed request; (5) the
    emitted server on the
    trainer's checkpoint, streams equal to an engine on
    ``restore_variables`` of it. Returns the
    launches of this phase's main path: the emitted trainer's and the
    servers' own counts, each measured in its process and held exactly
    to its steps or passes (the in-process runs are held to theirs too,
    and not added)."""
    import shutil

    import numpy as np

    from move2kube_tpu_torch import (
        Llama,
        TrainState,
        adamw,
        init_llama,
        instrument_optimizer,
        llama_8b,
        make_lm_train_step,
        policy,
        reset_launch_counts,
        restore_variables,
    )
    from move2kube_tpu_torch.containerizer.cuda_emit import (
        emit_container,
        write_payload,
    )
    from move2kube_tpu_torch.models.compile_cache import topology_fingerprint
    from move2kube_tpu_torch.models.convert import (
        infer_num_layers,
        llama_params_from_torch,
    )
    from move2kube_tpu_torch.ops import _build
    from move2kube_tpu_torch.ops.attention import KERNELS

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = dataclasses.replace(llama_8b(), num_layers=EMIT_LAYERS,
                              max_len=EMIT_SEQ, attn_impl="flash")
    # the HF file and the ported step 0 (4 bytes a parameter each), and
    # the trainer's steps 5 and 10 (12 each)
    need = _res_bytes_estimate(cfg) * 8 // 3 + (4 << 30)
    work = _res_workdir(need)
    launches = {k.name: 0 for k in KERNELS}
    try:
        # (1) the payloads
        services = emit_services(here)
        payload = {kind: write_payload(emit_container(svc),
                                       os.path.join(work, kind))
                   for kind, svc in services.items()}
        for kind, path in payload.items():
            n = sum(len(f) for _, _, f in os.walk(path))
            log(f"emit: {kind} payload {n} files under {path}")
        base = {k: v for k, v in os.environ.items()
                if not k.startswith("M2KT_") and k != "PYTHONPATH"}
        # every emitted program's kernel cache is seeded from this
        # process's builds (its start-up loads them, no nvcc run)
        prewarm = os.path.join(work, "prewarm")
        os.makedirs(prewarm)
        os.symlink(_build.build_dir(), os.path.join(prewarm,
                                                    topology_fingerprint()))
        base.update({
            "CUBLAS_WORKSPACE_CONFIG": os.environ["CUBLAS_WORKSPACE_CONFIG"],
            "M2KT_PREWARM_DIR": prewarm,
            "M2KT_COMPILE_CACHE_DIR": os.path.join(work, "kernels"),
            "M2KT_PREEMPT_FILE": os.path.join(work, "preempt"),
            "M2KT_FLIGHT_PATH": os.path.join(work, "flight.json"),
            "M2KT_USAGE_PATH": os.path.join(work, "usage.jsonl"),
            "M2KT_PROFILE_DIR": os.path.join(work, "profile"),
            "M2KT_DIAG_DIR": os.path.join(work, "diag")})

        # (2) weights in
        hf = os.path.join(work, "hf")
        os.makedirs(hf)
        t0 = time.perf_counter()
        _hf_llama(cfg, os.path.join(hf, "pytorch_model.bin"))
        t_draw = time.perf_counter() - t0
        ckpt = os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "port_weights.py", hf, ckpt], env=base,
            cwd=payload["train"], capture_output=True, text=True,
            timeout=EMIT_CHILD_TIMEOUT_S)
        t_port = time.perf_counter() - t0
        log(f"emit: port_weights| {res.stdout.strip()}")
        if res.returncode != 0 or "[m2kt] ported 15 arrays" not in res.stdout:
            raise RuntimeError(f"emit: port_weights exited {res.returncode}:"
                               f"\n{res.stderr[-3000:]}")
        log(f"emit: HF state dict drawn in {t_draw:.1f} s; port_weights.py "
            f"{t_port:.1f} s")

        # (3) the emitted trainer under the supervisor
        env = dict(base, **{f"M2KT_MESH_{a}": "1" for a in (
            "DATA", "FSDP", "PIPE", "TENSOR", "SEQ", "EXPERT")})
        env.update({
            "M2KT_LAYERS": str(EMIT_LAYERS), "M2KT_SEQ_LEN": str(EMIT_SEQ),
            "M2KT_BATCH_PER_DEVICE": str(EMIT_BATCH),
            "M2KT_STEPS": str(EMIT_STEPS), "M2KT_PRECISION": "bf16",
            "M2KT_CKPT_DIR": ckpt, "M2KT_CKPT_EVERY": str(EMIT_EVERY),
            "M2KT_METRICS_PORT": str(_free_port()),
            "M2KT_EXIT_FILE": os.path.join(work, "exit.json"),
            "M2KT_GOODPUT_FILE": os.path.join(work, "goodput.json")})
        t0 = time.perf_counter()
        trainer = _Child("trainer", [
            sys.executable, "-m", "move2kube_tpu_torch.resilience.supervisor",
            "--", sys.executable, "-c", DETERMINISTIC_PRELUDE], env,
            payload["train"])
        rc = trainer.finish(2 * EMIT_CHILD_TIMEOUT_S)
        t_train = time.perf_counter() - t0
        if rc != 0 or not any(x.startswith("[m2kt] done steps=10")
                              for x in trainer.lines):
            raise RuntimeError(f"emit: the emitted trainer exited {rc}")
        if "[m2kt] loaded ported weights from checkpoint step 0" \
                not in trainer.lines:
            raise RuntimeError("emit: the trainer did not start from the "
                               "ported weights")
        summary = json.load(open(env["M2KT_EXIT_FILE"]))
        rate = next(x for x in trainer.lines if x.startswith("[m2kt] done"))
        # the child's own counts: its 10 steps and the cost model's held
        # step, which runs the forward and backward once more
        got = json.loads(next(
            x for x in trainer.lines
            if x.startswith("[m2kt] kernel launches ")).split(" ", 3)[3])
        _check_launches("emit: the emitted trainer", got,
                        _want_train_launches(EMIT_STEPS + 1, EMIT_LAYERS))
        for name, n in got.items():
            launches[name] += n
        log(f"emit: trainer under the supervisor: {t_train:.1f} s wall, "
            f"exit class {summary['exit_class']}; under deterministic "
            f"algorithms with TF32 off: {rate}; launches {got} ({CARD})")

        # the same 10 steps here, from the same weights and batches
        pol = policy("bf16")
        model = init_llama(pol.apply_to_model_config(cfg), seed=SEED,
                           device="cuda", dtype=torch.float32)
        sd = torch.load(os.path.join(hf, "pytorch_model.bin"),
                        map_location="cpu", weights_only=True)
        model.load_state_dict(llama_params_from_torch(
            sd, infer_num_layers(sd, "llama")))
        del sd
        state = TrainState(model, instrument_optimizer(pol.wrap_optimizer(
            adamw(model.parameters(), EMIT_LR, weight_decay=EMIT_WD))))
        step_fn = make_lm_train_step(precision=pol)
        torch.use_deterministic_algorithms(True)
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            for i in range(EMIT_STEPS):
                ids = torch.from_numpy(np.random.default_rng(i).integers(
                    0, cfg.vocab_size, (EMIT_BATCH, EMIT_SEQ))).to("cuda")
                state, loss = step_fn(state, {"input_ids": ids})
            torch.cuda.synchronize()
            t_here = time.perf_counter() - t0
            got = {k.name: k.launches for k in KERNELS}
        finally:
            torch.use_deterministic_algorithms(False)
        _check_launches("emit: in-process training", got,
                        _want_train_launches(EMIT_STEPS, EMIT_LAYERS))
        names = [n for n, _ in model.named_parameters()]
        mine = _digest_tree(model.state_dict(),
                            state.optimizer.inner.state_dict(), names)
        saved = torch.load(os.path.join(ckpt, str(EMIT_STEPS), "state.pt"),
                           map_location="cpu", weights_only=True, mmap=True)
        theirs = _digest_tree(saved["model"], saved["optimizer"]["inner"],
                              names)
        differ = sorted(k for k in mine if theirs.get(k) != mine[k])
        if set(mine) != set(theirs) or differ:
            raise RuntimeError(f"emit: {len(differ)} of {len(mine)} tensors "
                               f"of the emitted trainer differ from the "
                               f"in-process run's: {differ[:6]}")
        log(f"emit: bit for bit: the emitted trainer's {len(mine)} final "
            f"tensors (parameters, exp_avg, exp_avg_sq) have the SHA-256 of "
            f"the in-process run's (loss {float(loss):.4f} at step "
            f"{EMIT_STEPS}; {t_here:.1f} s for the 10 steps here)")
        del state, model, saved, step_fn
        gc.collect()
        torch.cuda.empty_cache()

        # (4) the emitted server at full depth: at its defaults (the async
        # pipeline, one pass a window), then with windows of 4 passes
        prompts = _emit_requests(llama_8b().vocab_size)
        full = llama_8b()
        servers = {}
        for n_sub in (1, 4):
            label = "server" if n_sub == 1 else f"server N={n_sub}"
            # a diagnostic directory of its own: the first server's shed
            # request may rightly be captured there
            senv = dict(base, M2KT_SERVE_PORT="0", M2KT_WEIGHTS_PORT="0",
                        M2KT_METRICS_PORT=str(_free_port()),
                        M2KT_DIAG_DIR=os.path.join(work, f"diag-{n_sub}"))
            if n_sub > 1:
                senv["M2KT_DECODE_SUBSTEPS"] = str(n_sub)
            streams, stats, metrics, t_ready, t_req, bundles = _serve_child(
                label, payload["serve"], senv, prompts, 1, n_sub == 1)
            # a request alone in the engine decodes its EMIT_NEW - 1
            # tokens in whole windows; the warm request's one in one
            want_passes = dict.fromkeys(stats["passes"], 0)
            want_passes.update(prefill=len(prompts), decode=len(prompts)
                               * -(-(EMIT_NEW - 1) // n_sub) * n_sub)
            if (stats["passes"] != want_passes
                    or stats["warm"]["passes"] != dict(
                        want_passes, prefill=1, decode=n_sub)
                    or not stats["async_decode"]
                    or stats["decode_substeps"] != n_sub):
                raise RuntimeError(
                    f"emit: {label} passes {stats['passes']} (warm "
                    f"{stats['warm']['passes']}, async "
                    f"{stats['async_decode']}), the requests imply "
                    f"{want_passes} at {n_sub} passes a window")
            served = _traffic(f"emit: full-depth {label}", stats,
                              full.num_layers)
            for name, n in served["launches"].items():
                launches[name] += n
            # the warm request reaches no record, so the anomaly watchdog
            # has no SLO burn to capture at start: no bundle captured
            # before the shed request
            if bundles:
                raise RuntimeError(f"emit: {label}: diagnostic bundles "
                                   f"{bundles} captured before the shed "
                                   "request")
            resident, peak = (_metric(
                metrics, 'm2kt_serve_hbm_peak_bytes{executable="decode",'
                f'category="{cat}"}}') for cat in ("args", "total"))
            log(f"emit: full-depth {label}: /healthz after {t_ready:.1f} s; "
                f"the 4 prompts {t_req:.3f} s on the client's clock; /stats "
                f"(the warm request kept out): TTFT mean "
                f"{served['ttft_mean_ms']:.2f} ms, p50 "
                f"{stats['ttft_p50_ms']:.2f} ms, decode "
                f"{served['decode_ms']:.2f} ms a pass "
                f"({served['tokens_s']:.2f} tokens/s, one stream at a time),"
                f" host_overhead_ratio {stats['host_overhead_ratio']:.4f}; "
                f"resident {resident / 1e9:.3f} GB at a decode pass's start,"
                f" its peak {peak / 1e9:.3f} GB; passes {stats['passes']}, "
                f"launches {served['launches']}; no diagnostic bundle "
                f"captured before the shed request ({CARD})")
            servers[label] = (streams, served, t_req)
        model = init_llama(dataclasses.replace(full, max_len=2048,
                                               attn_impl="flash"),
                           seed=0, device="cuda").eval()
        here_streams, here, wall, busy = _engine_streams(
            torch, model, prompts, "emit: in-process replay", profile=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        for label, (streams, served, t_req) in servers.items():
            if streams != here_streams:
                raise RuntimeError(f"emit: {label} streams {streams} != the "
                                   f"in-process engine's {here_streams}")
        log(f"emit: both servers' streams (one over SSE) equal the "
            f"in-process synchronous engine's: {here_streams[0]}")
        log(f"emit: the same 4 prompts in process, synchronous: {wall:.3f} s"
            f" (the servers' " + ", ".join(
                f"{t:.3f}" for _, _, t in servers.values())
            + f" s); TTFT mean {here['ttft_mean_ms']:.2f} ms, decode "
            f"{here['decode_ms']:.2f} ms a step (the servers' " + ", ".join(
                f"{v['decode_ms']:.2f}" for _, v, _ in servers.values())
            + f"); a profiled decode step at 1 of 8 slots is {busy:.3f} ms "
            f"of device busy time ({CARD})")

        # (5) train -> serve
        tenv = dict(base, M2KT_SERVE_PORT="0", M2KT_WEIGHTS_PORT="0",
                    M2KT_LAYERS=str(EMIT_LAYERS), M2KT_CKPT_DIR=ckpt,
                    M2KT_METRICS_PORT=str(_free_port()))
        streams, stats, _, _, _, _ = _serve_child(
            "server-ckpt", payload["serve"], tenv, prompts[:2], -1, False)
        for name, n in _traffic("emit: checkpoint server", stats,
                                EMIT_LAYERS)["launches"].items():
            launches[name] += n
        model = Llama(dataclasses.replace(cfg, max_len=2048),
                      device="cuda").eval()
        model.load_state_dict(restore_variables(ckpt, model.state_dict()))
        here_streams = _engine_streams(torch, model, prompts[:2],
                                       "emit: in-process replay (ckpt)")[0]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if here_streams != streams:
            raise RuntimeError(f"emit: train -> serve streams {streams} != "
                               f"the in-process engine's {here_streams}")
        log(f"emit: train -> serve: the server on the trainer's step-"
            f"{EMIT_STEPS} checkpoint gives the in-process engine's streams "
            f"on restore_variables of it: {streams[0]}")
        # (6) the emitted GPT-2 trainer: the sample's data=8 mesh planned
        # on a one-card pod's world of one, over NCCL
        for name, n in _emit_gpt2_trainer(payload["gpt2"], base,
                                          work).items():
            launches[name] += n
        log(f"emit: phase {time.perf_counter() - t_phase:.1f} s ({CARD})")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# the emitted GPT-2 trainer's run: the sample's defaults (GPT-2 small,
# batch 8 x 1024 a device, the bf16 policy), 10 steps
EMIT_GPT2_STEPS = 10
# what the JAX trainer prints for the sample's baked mesh (data=8 on a
# 2x4 topology) on one device: the topology does not match one chip, so
# the slice is a chain of one and the plan is the one-device plan
EMIT_GPT2_PLAN = ("[m2kt] devices=1 mesh=1x1x1x1x1x1 topology=1 layout=[] "
                  "source=single-chip")


def _emit_gpt2_trainer(payload: str, base: dict, work: str) -> dict:
    """The emitted GPT-2 trainer under the port's supervisor with the env
    a one-card pod of the sample's JobSet gets (one host, one slice, host
    index 0): it brings up NCCL in a world of one, prints the JAX
    trainer's one-device plan line, trains 10 steps and, with
    ``M2KT_PLAN_REPORT``, writes the plan report on the H100 budget; its
    kernels are seeded from this process's builds (``base``'s
    ``M2KT_PREWARM_DIR``). Returns its launches, held to its 10 steps and
    the cost model's held one."""
    report = os.path.join(work, "plan-report")
    env = dict(base, M2KT_NUM_HOSTS="1", M2KT_NUM_SLICES="1",
               JOB_COMPLETION_INDEX="0", M2KT_STEPS=str(EMIT_GPT2_STEPS),
               M2KT_PLAN_REPORT=report,
               M2KT_COMPILE_CACHE_DIR=os.path.join(work, "gpt2-kernels"),
               M2KT_METRICS_PORT=str(_free_port()),
               M2KT_EXIT_FILE=os.path.join(work, "gpt2-exit.json"),
               M2KT_GOODPUT_FILE=os.path.join(work, "gpt2-goodput.json"))
    t0 = time.perf_counter()
    trainer = _Child("gpt2 trainer", [
        sys.executable, "-m", "move2kube_tpu_torch.resilience.supervisor",
        "--", sys.executable, "train_gpu.py"], env, payload)
    rc = trainer.finish(EMIT_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = trainer.lines
    plan = [x for x in lines if x.startswith("[m2kt] devices=")]
    device = next((x for x in lines if x.startswith("[m2kt] device=")), "")
    if rc != 0 or not any(x.startswith(f"[m2kt] done steps="
                                       f"{EMIT_GPT2_STEPS}") for x in lines):
        raise RuntimeError(f"emit: the emitted GPT-2 trainer exited {rc}")
    if plan != [EMIT_GPT2_PLAN]:
        raise RuntimeError(f"emit: GPT-2 trainer plan {plan}, the JAX "
                           f"trainer's one-device line is {EMIT_GPT2_PLAN}")
    if "backend=nccl" not in device.split():
        raise RuntimeError(f"emit: GPT-2 trainer process group: {device!r}")
    got = json.loads(next(x for x in lines if x.startswith(
        "[m2kt] kernel launches ")).split(" ", 3)[3])
    _check_launches("emit: the emitted GPT-2 trainer", got,
                    _want_train_launches(EMIT_GPT2_STEPS + 1, 12))
    with open(os.path.join(report, "m2kt-plan-report.json")) as f:
        doc = json.load(f)
    if not os.path.isfile(os.path.join(report, "m2kt-plan-report.md")):
        raise RuntimeError("emit: no m2kt-plan-report.md")
    pred, drift = doc["predicted"], doc["drift"]
    if (doc["accelerator"]["assumed_default"] or not drift[
            "measured_peak_hbm_bytes"] or doc["mesh"]["extents"]["data"] != 1):
        raise RuntimeError(f"emit: GPT-2 plan report {doc['accelerator']}, "
                           f"{drift}, {doc['mesh']}")
    rate = next(x for x in lines if x.startswith("[m2kt] done"))
    log(f"emit: GPT-2 trainer in a one-rank NCCL world: {device[7:]}; "
        f"{plan[0][7:]}; {rate[7:]}; {wall:.1f} s wall under the supervisor;"
        f" launches {got}; plan report on {doc['accelerator']['chip']} "
        f"({doc['accelerator']['requested']}): predicted "
        f"{pred['total_bytes'] / 2**30:.3f} GiB (params "
        f"{pred['params_bytes'] / 2**30:.3f}, grads "
        f"{pred['grads_bytes'] / 2**30:.3f}, Adam "
        f"{pred['opt_state_bytes'] / 2**30:.3f}, activations "
        f"{pred['activations_bytes'] / 2**30:.3f}), measured peak "
        f"{drift['measured_peak_hbm_bytes'] / 2**30:.3f} GiB, drift "
        f"{drift['predicted_over_measured']:.3f} (within "
        f"{drift['tolerance_factor']}x: {drift['within_tolerance']}), "
        f"verdict {doc['verdict']} ({CARD})")
    return got


# mesh_phase: GPT-2 small at full width and depth, trained data parallel
# by two ranks that share the one card (a gloo group, each ring hop
# through pinned host memory), grad_accum 2 through the overlapped path;
# the global batch is 4 rows of 1024 tokens a microbatch, 2 a rank
MESH_RANKS, MESH_BATCH, MESH_ACCUM, MESH_STEPS = 2, 4, 2, 3
MESH_CHILD_TIMEOUT_S = 600
# fp32, two ranks against one rank on the same global batch: the same
# arithmetic with the sums over the batch in another order. The loss
# within 1e-5 relative (tests/test_torch_dp_steps.py holds the same
# difference to 1e-5 at 2 layers); each parameter's distance from the
# one-rank run within 1e-3 of its 3-step update's norm: AdamW divides each
# gradient by its own running magnitude, so an entry whose gradient sits
# at rounding level moves by up to the learning rate either way, which
# tests/test_torch_families.py's UPDATE_REL (1e-3) already allows for.
# The key third of each c_attn bias shifts every score of a query row
# alike, so its gradient is rounding noise alone and AdamW moves each entry
# by up to the learning rate a step on its sign: it is held entry by entry
# to twice that over the steps (tests/test_torch_emitted_train.py's rule)
MESH_LOSS_REL = 1e-5
MESH_UPDATE_REL = 1e-3
MESH_LR = 1e-4


def _mesh_batches(vocab: int):
    import numpy as np

    return np.random.default_rng(SEED + 23).integers(
        0, vocab, (MESH_STEPS, MESH_ACCUM, MESH_BATCH, 1024))


def _mesh_train(torch, mode: str, ids, mesh=None, on_step=None):
    """MESH_STEPS steps of GPT-2 small (fp32 masters, ``mode``'s policy,
    AdamW at 1e-4, remat, grad_accum MESH_ACCUM) on ``ids`` [steps, k,
    rows, 1024], reduced across ``mesh`` when given; ``on_step(t, state,
    loss, ms)`` after each (synchronised) step, the last one run under
    the profiler. Returns (model, the profiled step's busy ms)."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        gpt2_small,
        init_gpt2,
        instrument_optimizer,
        make_lm_train_step,
        policy,
    )

    pol = policy(mode)
    model = init_gpt2(gpt2_small(), seed=SEED, device="cuda",
                      dtype=torch.float32)
    state = TrainState(model, instrument_optimizer(pol.wrap_optimizer(
        adamw(model.parameters(), MESH_LR, weight_decay=0.1))))
    step = make_lm_train_step(grad_accum=MESH_ACCUM, precision=pol,
                              mesh=mesh)
    busy = None
    for t in range(MESH_STEPS):
        batch = {"input_ids": ids[t]}
        out, wall = [], []

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(step(state, batch))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        if t == MESH_STEPS - 1:
            busy = _profiled(torch, f"mesh {mode} step {t + 1}", run)
        else:
            run()
        state, loss = out[0]
        if on_step is not None:
            on_step(t, state, float(loss), wall[0])
    return model, busy


def mesh_rank_child() -> int:
    """One rank of :func:`mesh_phase`'s world (``python chip_smoke.py
    --mesh-rank OUT``; the launcher's env names the rank and the
    rendezvous): both ranks on ``cuda:0`` in a gloo group, the bf16 policy
    then fp32, each step's parameters hashed; prints one ``MESH_RESULT``
    JSON line and, on rank 0, saves the fp32 run's final parameters to
    ``OUT.pt``."""
    import hashlib

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from move2kube_tpu_torch import gpt2_small, reset_launch_counts
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.mesh import (
        MeshConfig,
        initialize_distributed,
        make_mesh,
    )

    out = sys.argv[2]
    layout = initialize_distributed("cuda:0", backend="gloo")
    try:
        mesh = make_mesh(MeshConfig(data=layout.world), device="cuda")
        per = MESH_BATCH // layout.world
        ids = torch.from_numpy(_mesh_batches(gpt2_small().vocab_size)[
            :, :, layout.rank * per:(layout.rank + 1) * per]).cuda()
        result = {}
        for mode in ("bf16", "fp32"):
            steps = []

            def on_step(t, state, loss, ms, steps=steps):
                h = hashlib.sha256()
                for p in state.model.parameters():
                    h.update(p.detach().cpu().numpy().tobytes())
                steps.append({"loss": loss, "ms": ms, "sha": h.hexdigest(),
                              "ring": dict(overlap.RING_STATS)})

            reset_launch_counts()
            overlap.reset_ring_stats()
            model, busy = _mesh_train(torch, mode, ids, mesh, on_step)
            result[mode] = {"steps": steps, "busy_ms": busy,
                            "launches": {k.name: k.launches
                                         for k in KERNELS}}
            if mode == "fp32" and layout.rank == 0:
                torch.save({n: p.detach().cpu()
                            for n, p in model.named_parameters()},
                           out + ".pt")
            del model
            torch.cuda.empty_cache()
        result["seq"] = seq_rank_work(torch, layout, out)
        print("MESH_RESULT " + json.dumps(result), flush=True)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def mesh_phase(torch) -> dict:
    """Item 9a on the one card: two ranks of GPT-2 small at full width and
    depth (12 layers, d=768, s=1024) share ``cuda:0`` in a gloo world,
    each ring hop through pinned host memory, and train MESH_STEPS steps
    of grad_accum 2 through ``overlapped_accum_grads``, under the bf16
    policy and under fp32. Gates: after every step the two ranks'
    parameters have the same SHA-256; each rank's flash launches are its
    passes x layers; under fp32 the loss and each parameter after the
    steps match a one-rank run on the same global batch (MESH_LOSS_REL,
    MESH_UPDATE_REL). Reports each step's wall time, the ring's seconds
    (host copies and gloo apart), the bytes reduced a step and the
    device's busy share, beside the one-rank step. Returns both ranks'
    launches."""
    import shutil
    import tempfile

    import numpy as np

    from move2kube_tpu_torch import gpt2_small

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="m2kt-mesh-")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("M2KT_") and k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               M2KT_LOCAL_WORLD=str(MESH_RANKS), M2KT_DIST_TIMEOUT_S="300")
    layers = gpt2_small().num_layers
    try:
        ranks = [_Child(f"mesh rank {r}", [
            sys.executable, os.path.join(here, "chip_smoke.py"),
            "--mesh-rank", os.path.join(work, "rank")],
            dict(env, M2KT_LOCAL_RANK=str(r)), here)
            for r in range(MESH_RANKS)]
        rcs = []
        for r, child in enumerate(ranks):
            # a rank that failed leaves its peer waiting in the ring
            rcs.append(child.finish(MESH_CHILD_TIMEOUT_S if not any(rcs)
                                    else 30))
        if any(rcs):
            raise RuntimeError(f"mesh: ranks exited {rcs}")
        res = [json.loads(next(x for x in c.lines if x.startswith(
            "MESH_RESULT ")).split(" ", 1)[1]) for c in ranks]
        launches = dict.fromkeys(res[0]["fp32"]["launches"], 0)
        want = _want_train_launches(MESH_STEPS * MESH_ACCUM, layers)
        for r, doc in enumerate(res):
            for mode in ("bf16", "fp32"):
                _check_launches(f"mesh: rank {r} {mode}",
                                doc[mode]["launches"], want)
                for name, n in doc[mode]["launches"].items():
                    launches[name] += n
        for mode in ("bf16", "fp32"):
            for t in range(MESH_STEPS):
                shas = {doc[mode]["steps"][t]["sha"] for doc in res}
                if len(shas) != 1:
                    raise RuntimeError(f"mesh: {mode} step {t + 1}: the "
                                       f"ranks' parameters differ {shas}")
        log(f"mesh: after each of the {MESH_STEPS} steps, bf16 and fp32, "
            f"the {MESH_RANKS} ranks' parameters have one SHA-256 "
            f"(fp32 step {MESH_STEPS}: {res[0]['fp32']['steps'][-1]['sha'][:16]})"
            f"; launches a rank {want} = {layers} layers x "
            f"{MESH_STEPS * MESH_ACCUM} microbatches")

        # one rank on the same global batch, no mesh
        ids = torch.from_numpy(_mesh_batches(gpt2_small().vocab_size)).cuda()
        one = {}
        for mode in ("bf16", "fp32"):
            steps = []
            model, busy = _mesh_train(
                torch, mode, ids, None,
                lambda t, st, loss, ms, steps=steps: steps.append(
                    {"loss": loss, "ms": ms}))
            one[mode] = (steps, busy)
            if mode == "fp32":
                mine = torch.load(os.path.join(work, "rank.pt"))
                init = {n: p.detach().cpu() for n, p in
                        _mesh_init_params(torch).items()}
                worst, key_bias = (0.0, ""), 0.0
                d = gpt2_small().d_model
                for n, p in model.named_parameters():
                    p, theirs, p0 = p.detach().cpu(), mine[n], init[n]
                    if n.endswith("c_attn.bias"):
                        key_bias = max(key_bias, float(
                            (theirs[d:2 * d] - p[d:2 * d]).abs().max()))
                        keep = torch.cat([torch.arange(d),
                                          torch.arange(2 * d, 3 * d)])
                        p, theirs, p0 = p[keep], theirs[keep], p0[keep]
                    upd = float(torch.linalg.vector_norm(p - p0))
                    err = float(torch.linalg.vector_norm(theirs - p)) / max(
                        upd, 1e-30)
                    worst = max(worst, (err, n))
                losses = [(a["loss"], b["loss"]) for a, b in zip(
                    res[0]["fp32"]["steps"], steps)]
                loss_err = max(abs(a - b) / abs(b) for a, b in losses)
                key_gate = 2 * MESH_STEPS * MESH_LR
                if (loss_err > MESH_LOSS_REL or worst[0] > MESH_UPDATE_REL
                        or key_bias > key_gate):
                    raise RuntimeError(
                        f"mesh: fp32 two ranks against one: losses {losses}"
                        f" ({loss_err:.2e} > {MESH_LOSS_REL}?), worst "
                        f"parameter {worst[1]} at {worst[0]:.2e} of its "
                        f"update (> {MESH_UPDATE_REL}?), c_attn key bias "
                        f"{key_bias:.2e} (> {key_gate:.1e}?)")
                log(f"mesh: fp32, two ranks against one on the same global "
                    f"batch: losses {losses}, largest relative difference "
                    f"{loss_err:.2e} (gate {MESH_LOSS_REL}); worst parameter "
                    f"{worst[1]} {worst[0]:.2e} of its 3-step update (gate "
                    f"{MESH_UPDATE_REL}); the c_attn key biases {key_bias:.2e}"
                    f" apart at most (gate {key_gate:.1e})")
            del model
            torch.cuda.empty_cache()
        for mode in ("bf16", "fp32"):
            steps = res[0][mode]["steps"]
            totals = [x["ring"] for x in steps]
            ring = [totals[0]] + [{k: b[k] - a[k] for k in a}
                                  for a, b in zip(totals, totals[1:])]
            busy = sum(doc[mode]["busy_ms"] for doc in res)
            wall = steps[-1]["ms"]
            one_steps, one_busy = one[mode]
            log(f"mesh: {mode}, 2 ranks x {MESH_BATCH // MESH_RANKS} rows x "
                f"{MESH_ACCUM} microbatches of 1024 (global {MESH_BATCH}): "
                f"step wall " + ", ".join(f"{x['ms']:.1f}" for x in steps)
                + f" ms (step 1 warms up, step {MESH_STEPS} profiled); "
                f"ring a step (rank 0, step 2): {ring[1]['calls']} "
                f"reductions, {ring[1]['bytes'] / 1e9:.3f} GB reduced, host "
                f"copies {ring[1]['copy_s'] * 1e3:.1f} ms, gloo hops and "
                f"additions {ring[1]['ring_s'] * 1e3:.1f} ms; the profiled "
                f"step: both ranks' kernels busy {busy:.1f} ms of its "
                f"{wall:.1f} ms ({100 * busy / wall:.1f} % busy); one rank on "
                f"the global batch: " + ", ".join(
                    f"{x['ms']:.1f}" for x in one_steps)
                + f" ms a step, {one_busy:.1f} ms busy of "
                f"{one_steps[-1]['ms']:.1f} ({CARD})")
        # item 9d in the same world
        seq = seq_phase_checks(torch, work, res, layers)
        for name, n in seq.items():
            launches[name] += n
        log(f"mesh: phase {time.perf_counter() - t_phase:.1f} s, seq "
            f"included ({CARD})")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _mesh_init_params(torch) -> dict:
    from move2kube_tpu_torch import gpt2_small, init_gpt2

    return dict(init_gpt2(gpt2_small(), seed=SEED, device="cuda",
                          dtype=torch.float32).named_parameters())


# seq_phase (item 9d), run inside mesh_phase's two-rank world (one spawn,
# one CUDA start-up and one set of kernel loads for both):
# (a) GPT-2 small at full width and depth, gpt2-longctx's model
#     (n_positions 8192), one row of SEQ_TOKENS tokens, 4096 a rank,
#     remat, the head-folded loss, AdamW: SEQ_BF16_STEPS bf16 steps with
#     ring attention, as many with Ulysses (6 heads a rank), the ring's
#     last profiled (the first warms up), then one fp32 step of each,
#     against one rank on the same row with flash over all 8192 tokens;
# (b) Llama-8B's attention geometry alone, q [1, 8192, 32, 128], k/v [1,
#     8192, 8, 128] bf16: ring and Ulysses forward and backward over the
#     two ranks (GQA, d=128), against the plain fp32 attention over the
#     whole sequence by the flash and backward rules, one rank's
#     flash_attention beside them on the same rules; beside those, the
#     backward kernels on the plain o and lse (the backward rule's own
#     contract) and SDPA's forward and backward, read on the same rules
SEQ_TOKENS, SEQ_BF16_STEPS, SEQ_LR = 8192, 2, 1e-4
# fp32, two seq ranks against one rank on the same row: the same
# arithmetic with the keys' softmax merged by logsumexp and the gradient
# sums in another order. The loss within 1e-5 relative; each leaf's
# first-step gradient within 3e-5 of its norm, the key third of each
# c_attn bias apart: it shifts every score of a query row alike, so its
# gradient is rounding noise alone (mesh_phase's rule), and it is only
# reported
SEQ_LOSS_REL = 1e-5
SEQ_GRAD_REL = 3e-5
SEQ_ATTN = dict(b=1, h=32, kvh=8, d=128)


def _seq_cfg(impl: str):
    import dataclasses

    from move2kube_tpu_torch import gpt2_small

    return dataclasses.replace(gpt2_small(), n_positions=SEQ_TOKENS,
                               attn_impl=impl)


def _seq_ids(torch):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(SEED + 31).integers(
        0, _seq_cfg("flash").vocab_size, (1, SEQ_TOKENS))).cuda()


def _seq_train(torch, mode: str, impl: str, ids, steps: int, mesh=None,
               on_step=None, profile_last=False):
    """``steps`` steps of gpt2-longctx's model (fp32 masters, ``mode``'s
    policy, AdamW at SEQ_LR, remat, the head-folded loss) on the row
    ``ids``, over ``mesh``'s seq axis when given; ``on_step(t, state,
    loss, ms, busy)`` after each synchronised step (busy: the device's
    busy ms of a profiled step, else None). Returns the state."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_gpt2,
        instrument_optimizer,
        make_lm_train_step,
        policy,
    )

    pol = policy(mode)
    model = init_gpt2(_seq_cfg(impl), seed=SEED, device="cuda",
                      dtype=torch.float32)
    state = TrainState(model, instrument_optimizer(pol.wrap_optimizer(
        adamw(model.parameters(), SEQ_LR, weight_decay=0.1))))
    step = make_lm_train_step(precision=pol, mesh=mesh)
    for t in range(steps):
        out, wall = [], []

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(step(state, {"input_ids": ids}))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        busy = None
        if profile_last and t == steps - 1:
            busy = _profiled(torch, f"seq {mode} {impl} step {t + 1}", run)
        else:
            run()
        state, loss = out[0]
        if on_step is not None:
            on_step(t, state, float(loss), wall[0], busy)
    return state


def _seq_attention_inputs(torch):
    """(b)'s inputs, the same on every rank and in the parent."""
    b, h, kvh, d = (SEQ_ATTN[k] for k in ("b", "h", "kvh", "d"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    return [torch.randn(b, SEQ_TOKENS, n, d, device="cuda",
                        generator=gen).bfloat16() for n in (h, kvh, kvh, h)]


def seq_rank_work(torch, layout, out: str) -> dict:
    """A rank's share of seq_phase in mesh_phase's world: (a)'s runs, each
    step's loss, time, parameter digest, grad norm and ``sp_`` ring
    stats, each run's launches and peak, and (on rank 0) the fp32 runs'
    gradients in ``OUT-seq-<impl>-grads.pt``; then (b)'s forward and
    backward, each rank's shards of o, dq, dk, dv in
    ``OUT-seq-attn-<impl>-r<rank>.pt``."""
    import hashlib

    import torch.distributed as dist

    from move2kube_tpu_torch import grad_norm_from_state, reset_launch_counts
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from move2kube_tpu_torch.parallel.ring_attention import ring_attention
    from move2kube_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = make_mesh(MeshConfig(seq=layout.world), device="cuda")
    ids = _seq_ids(torch)
    result = {}
    for mode, impl, steps in (("bf16", "ring", SEQ_BF16_STEPS),
                              ("bf16", "ulysses", SEQ_BF16_STEPS),
                              ("fp32", "ring", 1), ("fp32", "ulysses", 1)):
        rec = []

        def on_step(t, state, loss, ms, busy, rec=rec):
            # the parameters' digests on the card (a copy to the host
            # would cost a second a step)
            h = hashlib.sha256()
            for p in state.model.parameters():
                h.update(_device_digest(torch, p).encode())
            rec.append({"loss": loss, "ms": ms, "busy_ms": busy,
                        "sha": h.hexdigest(),
                        "grad_norm": grad_norm_from_state(state),
                        "ring": dict(overlap.RING_STATS)})

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        overlap.reset_ring_stats()
        t_run = time.perf_counter()
        # the bf16 ring run's last step under the profiler: a profiled
        # step costs the script about 3.5 s
        state = _seq_train(torch, mode, impl, ids, steps, mesh, on_step,
                           profile_last=(mode, impl) == ("bf16", "ring"))
        log(f"seq rank {layout.rank}: {mode} {impl} {steps} step(s) "
            f"{time.perf_counter() - t_run:.1f} s")
        result[f"{mode}-{impl}"] = {
            "steps": rec, "peak": torch.cuda.max_memory_allocated(),
            "launches": {k.name: k.launches for k in KERNELS}}
        if mode == "fp32" and layout.rank == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in
                        state.model.named_parameters()},
                       f"{out}-seq-{impl}-grads.pt")
        del state
    # (b): the attention alone at Llama-8B's geometry
    gc.collect()
    torch.cuda.empty_cache()
    q, k, v, g = _seq_attention_inputs(torch)
    size = SEQ_TOKENS // layout.world
    cut = slice(layout.rank * size, (layout.rank + 1) * size)
    group = dist.group.WORLD
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        leaves = [t[:, cut].contiguous().requires_grad_() for t in (q, k, v)]
        reset_launch_counts()
        overlap.reset_ring_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*leaves, group, causal=True)
        torch.autograd.backward(o, g[:, cut].contiguous())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        torch.save({"o": o.detach().cpu(),
                    **{f"d{x}": t.grad.cpu() for x, t in zip("qkv", leaves)}},
                   f"{out}-seq-attn-{impl}-r{layout.rank}.pt")
        result[f"attn-{impl}"] = {
            "ms": ms, "ring": dict(overlap.RING_STATS),
            "launches": {k.name: k.launches for k in KERNELS}}
        del o, leaves
    return result


def _seq_want_launches(impl: str, rank: int, steps: int, layers: int
                       ) -> dict:
    """A rank's launches in (a): ring rank r runs r + 1 live blocks a
    layer (the forward, its remat recompute, dq, dkv); Ulysses one."""
    blocks = rank + 1 if impl == "ring" else 1
    return {"flash_fwd": 2 * blocks * layers * steps,
            "flash_bwd_dq": blocks * layers * steps,
            "flash_bwd_dkv": blocks * layers * steps,
            "paged_decode": 0, "paged_decode_int8": 0}


def _seq_reference_attention(torch, q, k, v, g, scale):
    """The plain fp32 attention over the whole sequence, a GQA group at a
    time (a [1, 4, 8192, 8192] fp32 score block each): per group of
    query heads, (o32, lse, P.|V|, (dq, dk, dv), their T terms)."""
    from move2kube_tpu_torch.ops import attention as att

    rep = q.shape[2] // k.shape[2]
    for j in range(k.shape[2]):
        qj, gj = q[:, :, j * rep:(j + 1) * rep], g[:, :, j * rep:(j + 1) * rep]
        kj, vj = k[:, :, j:j + 1], v[:, :, j:j + 1]
        o32, lse = att.reference_attention_lse(qj.float(), kj.float(),
                                               vj.float(), True, scale)
        pv = att.reference_attention_abs_v(qj, kj, vj, True, scale)
        o = o32.bfloat16().float()
        want = att.flash_attention_bwd_reference(
            qj.float(), kj.float(), vj.float(), o, lse, gj.float(), True,
            scale)
        terms = att.flash_attention_bwd_abs_terms(qj, kj, vj, o, lse, gj,
                                                  True, scale)
        yield j, o32, lse, pv, want, terms
        del o32, pv, want, terms, lse, o


def seq_phase_checks(torch, work: str, res: list, layers: int) -> dict:
    """mesh_phase's seq half, in the parent once the ranks are done:
    (a)'s gates against one rank on the same row, (b)'s against the plain
    attention; returns (a)'s launches summed over the ranks."""
    import torch.nn.functional as F

    from move2kube_tpu_torch import flash_attention, grad_norm_from_state
    from move2kube_tpu_torch.ops import attention as att

    t_seq = time.perf_counter()
    launches = dict.fromkeys(res[0]["seq"]["fp32-ring"]["launches"], 0)
    for r, doc in enumerate(res):
        for key, run in doc["seq"].items():
            if key.startswith("attn-"):
                impl = key[5:]
                want = _seq_want_launches(impl, r, 1, 1)
                want["flash_fwd"] //= 2  # no remat here
                _check_launches(f"seq: rank {r} attention {impl}",
                                run["launches"], want)
                continue
            mode, impl = key.split("-")
            _check_launches(f"seq: rank {r} {key}", run["launches"],
                            _seq_want_launches(impl, r, len(run["steps"]),
                                               layers))
            for name, n in run["launches"].items():
                launches[name] += n
    for key in res[0]["seq"]:
        if key.startswith("attn-"):
            continue
        for t in range(len(res[0]["seq"][key]["steps"])):
            shas = {doc["seq"][key]["steps"][t]["sha"] for doc in res}
            if len(shas) != 1:
                raise RuntimeError(f"seq: {key} step {t + 1}: the ranks' "
                                   f"parameters differ {shas}")
    log(f"seq: after every step of every run the {len(res)} ranks' "
        f"parameters have one SHA-256; launches a rank as the ring's live "
        f"blocks and Ulysses' one call give them, x {layers} layers x "
        f"steps, the forward twice (remat)")

    # (a) one rank on the same row, flash over all SEQ_TOKENS tokens
    ids = _seq_ids(torch)
    ref = {}
    for mode, steps in (("bf16", SEQ_BF16_STEPS), ("fp32", 1)):
        rec = []
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = _seq_train(
            torch, mode, "flash", ids, steps,
            on_step=lambda t, st, loss, ms, busy, rec=rec: rec.append(
                {"loss": loss, "ms": ms,
                 "grad_norm": grad_norm_from_state(st)}))
        ref[mode] = (rec, torch.cuda.max_memory_allocated())
        if mode == "fp32":
            grads = {n: p.grad.detach()
                     for n, p in state.model.named_parameters()}
        del state
    d = _seq_cfg("flash").d_model
    for impl in ("ring", "ulysses"):
        mine = res[0]["seq"][f"fp32-{impl}"]["steps"][0]
        theirs = ref["fp32"][0][0]
        loss_err = abs(mine["loss"] - theirs["loss"]) / abs(theirs["loss"])
        got = torch.load(os.path.join(work, f"rank-seq-{impl}-grads.pt"),
                         map_location="cuda")
        worst, key_bias = (0.0, ""), 0.0
        for n, want in grads.items():
            have = got[n]
            if n.endswith("c_attn.bias"):
                key_bias = max(key_bias, float(
                    (have[d:2 * d] - want[d:2 * d]).abs().max()))
                keep = torch.cat([torch.arange(d), torch.arange(2 * d, 3 * d)]
                                 ).to(have.device)
                have, want = have[keep], want[keep]
            err = float(torch.linalg.vector_norm(have - want)) / max(
                float(torch.linalg.vector_norm(want)), 1e-30)
            worst = max(worst, (err, n))
        if loss_err > SEQ_LOSS_REL or worst[0] > SEQ_GRAD_REL:
            raise RuntimeError(
                f"seq: fp32 {impl}, two seq ranks against one: loss "
                f"{mine['loss']} vs {theirs['loss']} ({loss_err:.2e} > "
                f"{SEQ_LOSS_REL}?), worst gradient {worst[1]} {worst[0]:.2e}"
                f" of its norm (> {SEQ_GRAD_REL}?)")
        log(f"seq: fp32 {impl}, two seq ranks of 4096 tokens against one "
            f"rank's flash over {SEQ_TOKENS}: loss {mine['loss']:.7f} vs "
            f"{theirs['loss']:.7f} ({loss_err:.2e}, gate {SEQ_LOSS_REL}); "
            f"worst leaf gradient {worst[1]} {worst[0]:.2e} of its norm "
            f"(gate {SEQ_GRAD_REL}); c_attn key-bias gradients {key_bias:.2e}"
            f" apart at most (rounding noise, reported)")
        steps = res[0]["seq"][f"bf16-{impl}"]["steps"]
        one = ref["bf16"][0]
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(steps, one))
        norm_rel = abs(steps[0]["grad_norm"] - one[0]["grad_norm"]) / abs(
            one[0]["grad_norm"])
        if not (loss_rel <= BF16_TRAIN_LOSS_REL
                and norm_rel <= BF16_TRAIN_GRAD_NORM_REL):
            raise RuntimeError(
                f"seq: bf16 {impl} against one rank: loss rel err "
                f"{loss_rel:.3e} (tol {BF16_TRAIN_LOSS_REL}), first grad "
                f"norm rel err {norm_rel:.3e} (tol "
                f"{BF16_TRAIN_GRAD_NORM_REL})")
        log(f"seq: bf16 {impl} against one rank: losses "
            + ", ".join(f"{a['loss']:.5f}/{b['loss']:.5f}"
                        for a, b in zip(steps, one))
            + f", largest rel err {loss_rel:.3e} (gate {BF16_TRAIN_LOSS_REL}"
            f"); first grad norm rel err {norm_rel:.3e} (gate "
            f"{BF16_TRAIN_GRAD_NORM_REL})")
    for mode in ("bf16", "fp32"):
        for impl in ("ring", "ulysses"):
            runs = [doc["seq"][f"{mode}-{impl}"] for doc in res]
            steps = runs[0]["steps"]
            totals = [x["ring"] for x in steps]
            last = totals[-1] if len(totals) == 1 else {
                k: totals[-1][k] - totals[-2][k] for k in totals[-1]}
            busy = [x["steps"][-1]["busy_ms"] for x in runs]
            busy_txt = ("; busy share not measured (no profiled step)"
                        if None in busy else
                        f"; the profiled step's kernels busy "
                        f"{sum(busy):.1f} ms of {steps[-1]['ms']:.1f} "
                        f"({100 * sum(busy) / steps[-1]['ms']:.1f} % busy)")
            log(f"seq: {mode} {impl}, 2 ranks x 4096 tokens: step wall "
                + ", ".join(f"{x['ms']:.1f}" for x in steps)
                + f" ms; the last step (rank 0): {last['sp_calls']} sp "
                f"exchanges, {last['sp_bytes'] / 1e9:.3f} GB sent, host "
                f"copies {last['sp_copy_s'] * 1e3:.1f} ms, gloo "
                f"{last['sp_ring_s'] * 1e3:.1f} ms; gradient ring "
                f"{last['bytes'] / 1e9:.3f} GB, {last['copy_s'] * 1e3:.1f} "
                f"+ {last['ring_s'] * 1e3:.1f} ms" + busy_txt
                + "; peak a rank " + ", ".join(
                    f"{x['peak'] / 2**30:.2f}" for x in runs)
                + f" GiB; one rank's flash over {SEQ_TOKENS}: "
                + ", ".join(f"{x['ms']:.1f}" for x in ref[mode][0])
                + f" ms, peak {ref[mode][1] / 2**30:.2f} GiB ({CARD})")

    log(f"seq: (a)'s checks {time.perf_counter() - t_seq:.1f} s")
    # (b) Llama-8B's attention geometry against the plain fp32 attention
    gc.collect()
    torch.cuda.empty_cache()
    q, k, v, g = _seq_attention_inputs(torch)
    scale = q.shape[-1] ** -0.5
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o1 = flash_attention(*leaves, causal=True)
    torch.autograd.backward(o1, g)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    got = {"flash": {"o": o1.detach(), **{f"d{x}": t.grad for x, t in
                                          zip("qkv", leaves)}}}
    del o1, leaves
    # SDPA's forward and backward on the same inputs, K/V repeated inside
    # the graph: a yardstick read on the same rules, never called by the
    # port
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o1 = F.scaled_dot_product_attention(
        *(_sdpa_layout(t, q.shape[2]) for t in leaves), is_causal=True)
    torch.autograd.backward(o1.transpose(1, 2), g)
    sdpa = {f"d{x}": t.grad for x, t in zip("qkv", leaves)}
    del o1, leaves
    for impl in ("ring", "ulysses"):
        parts = [torch.load(os.path.join(
            work, f"rank-seq-attn-{impl}-r{r}.pt"), map_location="cuda")
            for r in range(len(res))]
        got[impl] = {key: torch.cat([p_[key] for p_ in parts], 1)
                     for key in ("o", "dq", "dk", "dv")}
    rep = q.shape[2] // k.shape[2]
    # shares of each rule's allowance: o against the plain result (the
    # flash rule, gated for all three), each gradient against the plain
    # result (reported) and, for ring and Ulysses, against one rank's
    # flash_attention's (the backward rule, gated)
    keys = ("o", "dq", "dk", "dv")
    shares = {impl: dict.fromkeys(keys, 0.0) for impl in got}
    errs = {impl: dict.fromkeys(keys, 0.0) for impl in got}
    to_one = {impl: dict.fromkeys(keys[1:], 0.0) for impl in got}
    # the backward kernels on the plain o and lse, and SDPA end to end
    # (shares of the backward rule, reported)
    aside = {src: dict.fromkeys(keys[1:], 0.0) for src in ("plain", "sdpa")}
    for j, o32, lse, pv, want, terms in _seq_reference_attention(
            torch, q, k, v, g, scale):
        heads = slice(j * rep, (j + 1) * rep)
        on_plain = att.flash_attention_bwd(
            q[:, :, heads].contiguous(), k[:, :, j:j + 1].contiguous(),
            v[:, :, j:j + 1].contiguous(), o32.bfloat16(), lse,
            g[:, :, heads].contiguous(), True, scale)
        for name, x, y, t in zip(keys[1:], on_plain, want, terms):
            sl = heads if name == "dq" else slice(j, j + 1)
            for src, mine in (("plain", x), ("sdpa", sdpa[name][:, :, sl])):
                aside[src][name] = max(aside[src][name],
                                       bwd_shares(torch, mine, y, t)[0])
        del on_plain
        for impl, x in got.items():
            err, share = flash_check(torch, f"seq: {impl} o (Llama-8B "
                                     f"geometry, kv head {j})",
                                     x["o"][:, :, heads], o32, pv)
            shares[impl]["o"] = max(shares[impl]["o"], share)
            errs[impl]["o"] = max(errs[impl]["o"], err)
            for name, y, t in zip(keys[1:], want, terms):
                sl = heads if name == "dq" else slice(j, j + 1)
                mine = x[name][:, :, sl]
                share, _, err = bwd_shares(torch, mine, y, t)
                shares[impl][name] = max(shares[impl][name], share)
                errs[impl][name] = max(errs[impl][name], err)
                if impl == "flash":
                    continue
                one = got["flash"][name][:, :, sl].float()
                share = ((mine.float() - one).abs() / (
                    BF16_ATOL + BF16_RTOL * y.abs() + BWD_T_RTOL * t)
                         ).max().item()
                if not share <= 1:
                    raise RuntimeError(
                        f"seq: {impl} {name} (Llama-8B geometry, kv head "
                        f"{j}) differs from one rank's flash_attention by "
                        f"more than {BF16_ATOL} + {BF16_RTOL} |x| + "
                        f"{BWD_T_RTOL} T ({share:.3f} of the allowance at "
                        "worst)")
                to_one[impl][name] = max(to_one[impl][name], share)
    for impl in ("ring", "ulysses"):
        runs = [doc["seq"][f"attn-{impl}"] for doc in res]
        log(f"seq: {impl} attention at Llama-8B's geometry (q [1, "
            f"{SEQ_TOKENS}, 32, 128], k/v 8 heads, bf16, causal) over 2 "
            f"ranks, forward and backward: o within the flash rule of the "
            f"plain fp32 attention ({shares[impl]['o']:.3f} of its "
            f"allowance at worst); the gradients within the backward rule "
            f"of one rank's flash_attention's ("
            + ", ".join(f"{n} {to_one[impl][n]:.3f}" for n in keys[1:])
            + "), against the plain result "
            + ", ".join(f"{n} {shares[impl][n]:.3f}" for n in keys[1:])
            + "; max abs err " + ", ".join(
                f"{n} {errs[impl][n]:.3e}" for n in keys)
            + "; wall a rank " + ", ".join(f"{x['ms']:.1f}" for x in runs)
            + " ms (both ranks at once on the card, "
            f"{runs[0]['ring']['sp_bytes'] / 1e6:.1f} MB sent a rank) "
            f"against one rank's {one_ms:.1f} ms ({CARD})")
    log(f"seq: one rank's flash_attention forward and backward at that "
        f"geometry against the plain fp32 attention: "
        + ", ".join(f"{n} {shares['flash'][n]:.3f}" for n in keys)
        + " of the flash and backward rules' allowance (the backward rule "
        "holds the kernels on the plain residuals, bwd_phase; here each "
        "backward runs on its own forward's o and lse); the backward "
        "kernels on the plain o and lse at that geometry: "
        + ", ".join(f"{n} {aside['plain'][n]:.3f}" for n in keys[1:])
        + "; SDPA's forward and backward end to end: "
        + ", ".join(f"{n} {aside['sdpa'][n]:.3f}" for n in keys[1:])
        + " of the backward rule's allowance")
    log(f"seq: checks {time.perf_counter() - t_seq:.1f} s ({CARD})")
    return launches


# fsdp_phase: Llama-8B at full width, cut to FSDP_LAYERS layers, trained
# ZeRO-3 (fsdp=2) by two ranks that share the one card (a gloo group, each
# ring hop through pinned host memory): each rank holds its shards of the
# parameters and of the Adam moments, gathers them once a step and
# reduce-scatters each microbatch's gradients (grad_accum 2, the
# prefetched schedule; once more M2KT_FSDP_PREFETCH=off's sequential one).
# Each rank takes 1 row of 2048 tokens a microbatch
FSDP_RANKS, FSDP_ACCUM, FSDP_STEPS, FSDP_LAYERS = 2, 2, 3, 2
# the sequential schedule's run, held to the prefetched one's tree after
# as many steps
FSDP_OFF_STEPS = 2
FSDP_SEQ = 2048
FSDP_CHILD_TIMEOUT_S = 600
# fp32 against one rank on the same global batch, and the two schedules
# against each other: the same arithmetic with the sums in another order
# (ranks, ring, microbatches), as in mesh_phase. The loss within 1e-5
# relative; each parameter's distance within 1e-3 of its 3-step update's
# norm, AdamW's rounding-level entries moving by up to the learning rate
# (MESH_UPDATE_REL's reason). Llama has no bias whose gradient is
# rounding noise alone
FSDP_LOSS_REL = 1e-5
FSDP_UPDATE_REL = 1e-3
FSDP_LR = 1e-4


def _fsdp_cfg():
    from move2kube_tpu_torch import llama_8b

    return dataclasses.replace(llama_8b(), num_layers=FSDP_LAYERS,
                               max_len=FSDP_SEQ, attn_impl="flash")


def _fsdp_batches(vocab: int):
    import numpy as np

    return np.random.default_rng(SEED + 29).integers(
        0, vocab, (FSDP_STEPS, FSDP_ACCUM, FSDP_RANKS, FSDP_SEQ))


def _fsdp_train(torch, mode: str, ids, mesh=None, on_step=None,
                steps: int = FSDP_STEPS):
    """``steps`` steps of the cut Llama-8B (fp32 masters, ``mode``'s
    policy, AdamW at FSDP_LR, remat, grad_accum FSDP_ACCUM) on ``ids``
    [steps, k, rows, seq]: sharded over ``mesh``'s fsdp axis when given
    (``create_sharded_state``, seed SEED), else ``init_llama``'s whole
    tree from the same seed; ``on_step(t, state, loss, ms)`` after each
    synchronised step, the last one under the profiler. Returns (state,
    the profiled step's busy ms)."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        create_sharded_state,
        init_llama,
        instrument_optimizer,
        make_lm_train_step,
        policy,
    )

    pol = policy(mode)

    def make_opt(params):
        return instrument_optimizer(pol.wrap_optimizer(
            adamw(params, FSDP_LR, weight_decay=0.1)))

    cfg = _fsdp_cfg()
    if mesh is not None:
        state = create_sharded_state(cfg, mesh, make_opt, seed=SEED,
                                     device="cuda")
    else:
        model = init_llama(cfg, seed=SEED, device="cuda",
                           dtype=torch.float32)
        state = TrainState(model, make_opt(model.parameters()))
    step = make_lm_train_step(grad_accum=FSDP_ACCUM, precision=pol,
                              mesh=mesh)
    busy = None
    for t in range(steps):
        batch = {"input_ids": ids[t]}
        out, wall = [], []

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(step(state, batch))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        if t == steps - 1:
            busy = _profiled(torch, f"fsdp {mode} step {t + 1}", run)
        else:
            run()
        state, loss = out[0]
        if on_step is not None:
            on_step(t, state, float(loss), wall[0])
    return state, busy


def _fsdp_resident(state) -> tuple[int, int]:
    """A state's resident bytes: its parameters, and its Adam moments."""
    params = sum(p.numel() * p.element_size()
                 for p in state.model.parameters())
    moments = sum(v.numel() * v.element_size()
                  for slots in state.optimizer.inner.state.values()
                  for k, v in slots.items() if k in ("exp_avg",
                                                     "exp_avg_sq"))
    return params, moments


# a digest's chunk of entries: bounds its int64 temporaries to 64 MB
_DIGEST_CHUNK = 1 << 23


def _device_digest(torch, t) -> str:
    """Two int64 sums of ``t``'s bits, plain and weighted by position,
    computed on ``t``'s device: equal for equal bits, and for a flipped
    bit or moved entries unequal but by chance."""
    bits = t.detach().contiguous().view(-1)
    bits = bits.view({2: torch.int16, 4: torch.int32,
                      8: torch.int64}[bits.element_size()])
    plain = weighted = 0
    for at in range(0, bits.numel(), _DIGEST_CHUNK):
        x = bits[at:at + _DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(at, at + x.numel(), device=x.device) % 65521 + 1
        plain += int(x.sum())
        weighted += int((x * w).sum())
    return f"{plain}:{weighted}"


def _gathered_tree(state, ring, gather) -> dict:
    """The state's parameters at their global shapes on the host (each
    shard all-gathered through ``ring`` by ``gather``)."""
    lay = state.model.fsdp_layout
    out = {}
    for name, p in state.model.named_parameters():
        dim = lay.dims[name]
        full = p.detach() if dim is None else gather(p.detach(), ring, dim)
        out[name] = full.cpu()
    return out


def fsdp_rank_child() -> int:
    """One rank of :func:`fsdp_phase`'s world (``python chip_smoke.py
    --fsdp-rank OUT``; the launcher's env names the rank and the
    rendezvous): both ranks on ``cuda:0`` in a gloo group, the bf16 policy,
    fp32, then fp32 under ``M2KT_FSDP_PREFETCH=off``. Every all-gather the
    steps make is checked as it returns: this rank's shard is its slice of
    the gathered tensor, bit for bit, and the tensor's digest
    (:func:`_device_digest`) is kept; after each step the step's digests
    and the replicated leaves' are hashed. Prints one ``FSDP_RESULT``
    JSON line; rank 0 saves the fp32 prefetched run's gathered parameters
    after its last step (``OUT-auto.pt``, for the one-rank run) and holds
    the sequential run's after its last to the prefetched run's after as
    many steps (the result's ``off_vs_auto``). Those gathers are outside
    the steps, their checks and their ring counts."""
    import hashlib

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from move2kube_tpu_torch import reset_launch_counts
    from move2kube_tpu_torch.models.convert import meta_model
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.memory import train_memory_plan
    from move2kube_tpu_torch.parallel.mesh import (
        MeshConfig,
        initialize_distributed,
        make_mesh,
    )

    out = sys.argv[2]
    layout = initialize_distributed("cuda:0", backend="gloo")
    gather = overlap.ring_all_gather
    seen = {"digests": [], "slices_ok": True}

    def checked_gather(shard, group=None, dim=0, stream=None):
        # every gather of the step (the leaves its forward used, and the
        # optimizer's scalars): the rank's shard is its slice
        full = gather(shard, group, dim, stream)
        size = shard.shape[dim]
        r = dist.get_rank(group or dist.group.WORLD)
        seen["slices_ok"] &= torch.equal(full.narrow(dim, r * size, size),
                                         shard)
        seen["digests"].append(_device_digest(torch, full))
        return full

    overlap.ring_all_gather = checked_gather
    try:
        mesh = make_mesh(MeshConfig(fsdp=layout.world), device="cuda")
        ring = overlap.mesh_ring_group(mesh, ("fsdp",))
        cfg = _fsdp_cfg()
        ids = torch.from_numpy(_fsdp_batches(cfg.vocab_size)[
            :, :, layout.rank:layout.rank + 1]).cuda()
        extents = dict.fromkeys(MeshConfig.AXES, 1)
        extents["fsdp"] = layout.world
        plan = train_memory_plan(meta_model(cfg), extents, seq_len=FSDP_SEQ,
                                 batch_per_chip=1, d_model=cfg.d_model,
                                 num_layers=cfg.num_layers,
                                 vocab_size=cfg.vocab_size)
        result = {"plan": {"params": plan.params,
                           "opt_state": plan.opt_state,
                           "total": plan.total}}
        # the prefetched fp32 run's tree after FSDP_OFF_STEPS steps
        at_step2 = {}
        for mode, sched, n_steps in (("bf16", "auto", FSDP_STEPS),
                                     ("fp32", "auto", FSDP_STEPS),
                                     ("fp32", "off", FSDP_OFF_STEPS)):
            os.environ["M2KT_FSDP_PREFETCH"] = sched
            steps = []
            keep = (mode, sched) == ("fp32", "auto")
            seen.update(digests=[], slices_ok=True)

            def on_step(t, state, loss, ms, steps=steps, keep=keep):
                lay = state.model.fsdp_layout
                rep = " ".join(
                    _device_digest(torch, p)
                    for name, p in state.model.named_parameters()
                    if lay.dims[name] is None)
                steps.append({
                    "loss": loss, "ms": ms,
                    "replicated": hashlib.sha256(rep.encode()).hexdigest(),
                    "gathered": hashlib.sha256(
                        " ".join(seen["digests"]).encode()).hexdigest(),
                    "gathers": len(seen["digests"]),
                    "slices_ok": bool(seen["slices_ok"]),
                    "ring": dict(overlap.RING_STATS)})
                if keep and t == FSDP_OFF_STEPS - 1:
                    # the tree the sequential run is held to, gathered
                    # outside the steps and their ring counts
                    ring_stats = dict(overlap.RING_STATS)
                    at_step2.update(_gathered_tree(state, ring, gather))
                    overlap.RING_STATS.update(ring_stats)
                seen.update(digests=[], slices_ok=True)

            reset_launch_counts()
            overlap.reset_ring_stats()
            torch.cuda.reset_peak_memory_stats()
            state, busy = _fsdp_train(torch, mode, ids, mesh, on_step,
                                      n_steps)
            params, moments = _fsdp_resident(state)
            # what the schedule holds beyond the plan: the plan report's
            # flag of it
            extra = overlap.fsdp_transient_bytes(
                state.model.fsdp_layout, overlap.fsdp_prefetched(mesh),
                FSDP_ACCUM, torch.bfloat16 if mode == "bf16"
                else torch.float32)
            result[f"{mode}-{sched}"] = {
                "steps": steps, "busy_ms": busy, "transients": extra,
                "params_bytes": params, "moment_bytes": moments,
                "peak": torch.cuda.max_memory_allocated(),
                "launches": {k.name: k.launches for k in KERNELS}}
            if mode == "fp32":
                tree = _gathered_tree(state, ring, gather)
                if layout.rank == 0 and sched == "auto":
                    torch.save(tree, f"{out}-{sched}.pt")
                elif layout.rank == 0:
                    from move2kube_tpu_torch import init_llama

                    init = {n: p.detach().cpu() for n, p in init_llama(
                        cfg, seed=SEED, device="cuda",
                        dtype=torch.float32).named_parameters()}
                    result["off_vs_auto"] = _worst_update(
                        torch, at_step2, tree, init)
                    del init
                del tree
            del state
            gc.collect()
            torch.cuda.empty_cache()
        print("FSDP_RESULT " + json.dumps(result), flush=True)
    finally:
        overlap.ring_all_gather = gather
        dist.destroy_process_group()
    return 0


def _worst_update(torch, theirs: dict, mine: dict, init: dict):
    """(the largest distance of a parameter of ``mine`` from ``theirs``
    in units of its update from ``init``, its name)."""
    worst = (0.0, "")
    for n, p in theirs.items():
        upd = float(torch.linalg.vector_norm(p - init[n]))
        err = float(torch.linalg.vector_norm(mine[n] - p)) / max(upd, 1e-30)
        worst = max(worst, (err, n))
    return worst


def fsdp_phase(torch) -> dict:
    """Item 9b on the one card: two ranks of Llama-8B at full width, cut
    to FSDP_LAYERS layers, share ``cuda:0`` in a gloo world and train
    FSDP_STEPS steps of grad_accum 2 ZeRO-3 (fsdp=2), under the bf16
    policy and fp32 through the prefetched schedule, and FSDP_OFF_STEPS
    of fp32 through the sequential one. Gates: each rank's resident
    parameter and Adam moment bytes equal the memory plan's per-device
    ``params`` and ``opt_state`` at {fsdp: 2} to the byte; in every step
    each rank's shard is its slice of every tree it gathered, and the
    gathered trees (by their digests) are bit-identical on both ranks, so
    the shards put together are the tree each rank used; after every
    step the replicated leaves are bit-identical across the ranks (by
    their digests); each rank's flash launches are its passes x layers; under fp32 the loss
    and each parameter after the steps match a one-rank unsharded run on
    the same global batch, and the sequential schedule the prefetched one
    after as many steps (FSDP_LOSS_REL, FSDP_UPDATE_REL). Reports each
    rank's peak against the plan's prediction (and the fp32 runs' against
    the one-rank run's), the step's wall time, the gathers' and
    reduce-scatters' seconds and bytes (host copies and gloo apart) and
    the device's busy share. Returns both ranks' launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="m2kt-fsdp-")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("M2KT_") and k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               M2KT_LOCAL_WORLD=str(FSDP_RANKS), M2KT_DIST_TIMEOUT_S="300")
    cfg = _fsdp_cfg()
    try:
        ranks = [_Child(f"fsdp rank {r}", [
            sys.executable, os.path.join(here, "chip_smoke.py"),
            "--fsdp-rank", os.path.join(work, "rank")],
            dict(env, M2KT_LOCAL_RANK=str(r)), here)
            for r in range(FSDP_RANKS)]
        rcs = []
        for child in ranks:
            # a rank that failed leaves its peer waiting in the ring
            rcs.append(child.finish(FSDP_CHILD_TIMEOUT_S if not any(rcs)
                                    else 30))
        if any(rcs):
            raise RuntimeError(f"fsdp: ranks exited {rcs}")
        res = [json.loads(next(x for x in c.lines if x.startswith(
            "FSDP_RESULT ")).split(" ", 1)[1]) for c in ranks]
        runs = {"bf16-auto": FSDP_STEPS, "fp32-auto": FSDP_STEPS,
                "fp32-off": FSDP_OFF_STEPS}
        plan = res[0]["plan"]
        launches = dict.fromkeys(res[0]["fp32-auto"]["launches"], 0)
        for r, doc in enumerate(res):
            for run, n_steps in runs.items():
                d = doc[run]
                want = _want_train_launches(n_steps * FSDP_ACCUM,
                                            FSDP_LAYERS)
                if (d["params_bytes"], d["moment_bytes"]) != (
                        plan["params"], plan["opt_state"]):
                    raise RuntimeError(
                        f"fsdp: rank {r} {run} holds {d['params_bytes']} B "
                        f"of parameters and {d['moment_bytes']} B of Adam "
                        f"moments; the plan at fsdp=2 says {plan['params']}"
                        f" and {plan['opt_state']}")
                _check_launches(f"fsdp: rank {r} {run}", d["launches"],
                                want)
                for name, n in d["launches"].items():
                    launches[name] += n
                for t, step in enumerate(d["steps"]):
                    if not step["slices_ok"] or not step["gathers"]:
                        raise RuntimeError(
                            f"fsdp: rank {r} {run} step {t + 1}: a shard is"
                            " not its slice of a tree the step gathered "
                            f"({step['gathers']} gathers)")
        gathers = {}
        for run in runs:
            for t, step in enumerate(res[0][run]["steps"]):
                gathers[run] = gathers.get(run, []) + [step["gathers"]]
                for what in ("gathered", "replicated"):
                    shas = {doc[run]["steps"][t][what] for doc in res}
                    if len(shas) != 1:
                        raise RuntimeError(f"fsdp: {run} step {t + 1}: the "
                                           f"ranks' {what} trees differ "
                                           f"{shas}")
        log(f"fsdp: each rank holds {plan['params']} B of parameters and "
            f"{plan['opt_state']} B of Adam moments, the memory plan's "
            f"per-device bytes at fsdp=2; in every step of every run each "
            f"rank's shards are their slices of every tree it gathered "
            f"(gathers a step {gathers}), the gathered trees have one "
            f"digest on both ranks and, after the step, the replicated "
            f"leaves one digest; launches a rank a run are {FSDP_LAYERS} "
            f"layers x the microbatches")

        # one rank on the same global batch, unsharded
        ids = torch.from_numpy(_fsdp_batches(cfg.vocab_size)).cuda()
        one = {}
        from move2kube_tpu_torch import init_llama

        init = {n: p.detach().cpu() for n, p in init_llama(
            cfg, seed=SEED, device="cuda",
            dtype=torch.float32).named_parameters()}
        # the fp32 policy alone: the bf16 runs have no one-rank twin
        steps = []
        torch.cuda.reset_peak_memory_stats()
        state, busy = _fsdp_train(
            torch, "fp32", ids, None,
            lambda t, st, loss, ms, steps=steps: steps.append(
                {"loss": loss, "ms": ms}))
        one["fp32"] = (steps, busy, torch.cuda.max_memory_allocated())
        mine = {n: p.detach().cpu()
                for n, p in state.model.named_parameters()}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        gates = []
        for label, run, worst, ref_steps in (
                ("two ranks (prefetched) against one", "fp32-auto",
                 _worst_update(torch, mine, torch.load(
                     os.path.join(work, "rank-auto.pt")), init), steps),
                ("the sequential schedule against the prefetched",
                 "fp32-off", tuple(res[0]["off_vs_auto"]),
                 res[0]["fp32-auto"]["steps"])):
            losses = [(a["loss"], b["loss"]) for a, b in zip(
                res[0][run]["steps"], ref_steps)]
            loss_err = max(abs(a - b) / abs(b) for a, b in losses)
            gates.append((label, losses, loss_err, worst, runs[run]))
            if loss_err > FSDP_LOSS_REL or worst[0] > FSDP_UPDATE_REL:
                raise RuntimeError(
                    f"fsdp: fp32, {label}: losses {losses} "
                    f"({loss_err:.2e} > {FSDP_LOSS_REL}?), worst "
                    f"parameter {worst[1]} at {worst[0]:.2e} of its "
                    f"update (> {FSDP_UPDATE_REL}?)")
        for label, losses, loss_err, worst, n_steps in gates:
            log(f"fsdp: fp32, {label} on the same global batch: "
                f"losses {losses}, largest relative difference "
                f"{loss_err:.2e} (gate {FSDP_LOSS_REL}); worst "
                f"parameter {worst[1]} {worst[0]:.2e} of its "
                f"{n_steps}-step update (gate {FSDP_UPDATE_REL})")
        for run in runs:
            mode = run.split("-")[0]
            steps = res[0][run]["steps"]
            totals = [x["ring"] for x in steps]
            ring = [totals[0]] + [{k: b[k] - a[k] for k in a}
                                  for a, b in zip(totals, totals[1:])]
            r2 = ring[1]
            busy = sum(doc[run]["busy_ms"] for doc in res)
            wall = steps[-1]["ms"]
            peaks = [doc[run]["peak"] for doc in res]
            extra = res[0][run]["transients"]
            vs_one = ""
            if mode in one:
                one_steps, one_busy, one_peak = one[mode]
                vs_one = (
                    f" and one rank's {one_peak} B on the global batch ("
                    + ", ".join(f"{p / one_peak:.3f}" for p in peaks)
                    + " of it); one rank: "
                    + ", ".join(f"{x['ms']:.1f}" for x in one_steps)
                    + f" ms a step, {one_busy:.1f} ms busy of "
                    f"{one_steps[-1]['ms']:.1f}")
            log(f"fsdp: {run}, 2 ranks x 1 row x {FSDP_ACCUM} microbatches "
                f"of {FSDP_SEQ} (global 2 rows): step wall "
                + ", ".join(f"{x['ms']:.1f}" for x in steps)
                + f" ms (step 1 warms up, step {runs[run]} profiled); "
                f"rank 0, step 2: all-gathers {r2['ag_calls']} calls "
                f"{r2['ag_bytes'] / 1e9:.3f} GB (host copies "
                f"{r2['ag_copy_s'] * 1e3:.1f} ms, gloo hops "
                f"{r2['ag_ring_s'] * 1e3:.1f} ms), reduce-scatters "
                f"{r2['rs_calls']} calls {r2['rs_bytes'] / 1e9:.3f} GB "
                f"(host copies {r2['rs_copy_s'] * 1e3:.1f} ms, gloo hops and "
                f"additions {r2['rs_ring_s'] * 1e3:.1f} ms), all-reduces "
                f"{r2['calls']} calls {r2['bytes'] / 1e9:.3f} GB (host copies"
                f" {r2['copy_s'] * 1e3:.1f} ms, gloo {r2['ring_s'] * 1e3:.1f}"
                f" ms); the profiled step: both ranks' kernels busy "
                f"{busy:.1f} ms of its {wall:.1f} ms ({100 * busy / wall:.1f}"
                f" % busy); peak {peaks} B a rank against the plan's "
                f"{plan['total']} B (drift "
                + ", ".join(f"{plan['total'] / p:.3f}" for p in peaks)
                + f"; with the {extra['schedule']} schedule's "
                f"{extra['total_bytes']} B beyond it, "
                + ", ".join(f"{(plan['total'] + extra['total_bytes']) / p:.3f}"
                            for p in peaks)
                + f"){vs_one} ({CARD})")
        log(f"fsdp: phase {time.perf_counter() - t_phase:.1f} s ({CARD})")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# item 9c: two tensor ranks of Llama-8B's widths (a), two expert ranks of
# the MoE Llama at Mixtral's widths (b), sharing the one card through gloo
TP_RANKS, TP_ACCUM, TP_STEPS, TP_LAYERS, TP_SEQ = 2, 2, 3, 2, 2048
TP_MOE_STEPS, TP_MOE_LAYERS = 2, 1
TP_CHILD_TIMEOUT_S = 420
# fp32 against one rank on the same batch: the row-split products, the
# column entries' summed gradients and the vocab-parallel loss sum over
# the ranks in another order. Every leaf's gradient, cut or whole, is
# held to one rank's each step (TP_GRAD_REL of its norm), and every
# leaf's parameters after the last step (TP_PARAM_REL of its update:
# AdamW moves an entry whose gradient is rounding noise by up to the
# learning rate in either run, about 1e-3 of the update on the card; a
# skipped or stale update is about 1)
TP_LOSS_REL = 1e-5
TP_GRAD_REL = 1e-4
TP_PARAM_REL = 1e-2
TP_LR = 1e-4


def _tp_cfgs():
    """(a) Llama-8B's widths cut to TP_LAYERS layers; (b) the MoE Llama at
    Mixtral's widths (d 4096, 32/8 heads, mlp 14336, 8 experts, top 2)
    cut to TP_MOE_LAYERS."""
    from move2kube_tpu_torch import llama_8b

    dense = dataclasses.replace(llama_8b(), num_layers=TP_LAYERS,
                                max_len=TP_SEQ, attn_impl="flash")
    moe = dataclasses.replace(dense, num_layers=TP_MOE_LAYERS, moe_experts=8,
                              moe_top_k=2)
    return {"a": (dense, {"tensor": TP_RANKS}, TP_STEPS, ("bf16", "fp32")),
            "b": (moe, {"expert": TP_RANKS}, TP_MOE_STEPS, ("fp32",))}


def _tp_run(torch, cfg, mode, ids, mesh, steps, on_step):
    """``steps`` steps (fp32 masters, ``mode``'s policy, AdamW at TP_LR,
    remat, grad_accum TP_ACCUM) of ``cfg`` on ``ids`` [steps, k, 1, seq]:
    this rank's parts over ``mesh`` (``create_sharded_state``, seed SEED),
    or with no mesh ``init_llama``'s whole tree from the same seed;
    ``on_step(t, state, loss, ms)`` after each synchronised step."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        create_sharded_state,
        init_llama,
        make_lm_train_step,
        policy,
    )

    pol = policy(mode)

    def make_opt(params):
        return pol.wrap_optimizer(adamw(params, TP_LR, weight_decay=0.1))

    if mesh is not None:
        state = create_sharded_state(cfg, mesh, make_opt, seed=SEED,
                                     device="cuda")
    else:
        model = init_llama(cfg, seed=SEED, device="cuda",
                           dtype=torch.float32)
        state = TrainState(model, make_opt(model.parameters()))
    step = make_lm_train_step(grad_accum=TP_ACCUM, precision=pol, mesh=mesh)
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, {"input_ids": ids[t]})
        torch.cuda.synchronize()
        on_step(t, state, float(loss), (time.perf_counter() - t0) * 1e3)
    return state


def tp_rank_child() -> int:
    """One rank of :func:`tp_phase`'s worlds (``python chip_smoke.py
    --tp-rank OUT``; the launcher's env names the rank and the
    rendezvous): both ranks on ``cuda:0`` in a gloo group. For (a) at
    tensor=2 under the bf16 policy and fp32, and (b) at expert=2 in fp32:
    the steps, counted (launches, ring bytes and seconds, peak); after
    each step the digests of the leaves whole on both ranks and (fp32) a
    host copy of this rank's gradient of every leaf, and of its
    parameters after the last step. Then, the world's state freed, the
    same steps on one rank's whole tree from the same seed on the same
    batch: after each step this rank's gradient of every leaf, cut or
    whole, against its slice of one rank's (the worst relative distance
    of the cut leaves and of the whole ones), after the last its
    parameters (in units of the update). Prints one ``TP_RESULT`` JSON
    line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    import torch.distributed as dist

    from move2kube_tpu_torch import reset_launch_counts
    from move2kube_tpu_torch.models.convert import meta_model
    from move2kube_tpu_torch.ops.attention import KERNELS
    from move2kube_tpu_torch.parallel import overlap
    from move2kube_tpu_torch.parallel.memory import train_memory_plan
    from move2kube_tpu_torch.parallel.mesh import (
        MeshConfig,
        initialize_distributed,
        make_mesh,
    )
    from move2kube_tpu_torch.parallel.sharding import layout_of

    initialize_distributed("cuda:0", backend="gloo")
    result = {}
    try:
        for key, (cfg, axes, steps, modes) in _tp_cfgs().items():
            mesh = make_mesh(MeshConfig(**axes), device="cuda")
            extents = {**dict.fromkeys(MeshConfig.AXES, 1), **axes}
            plan = train_memory_plan(
                meta_model(cfg), extents, seq_len=TP_SEQ, batch_per_chip=1,
                d_model=cfg.d_model, num_layers=cfg.num_layers,
                vocab_size=cfg.vocab_size)
            ids = torch.from_numpy(np.random.default_rng(SEED + 31).integers(
                0, cfg.vocab_size, (steps, TP_ACCUM, 1, TP_SEQ))).cuda()
            for mode in modes:
                run = {"steps": [], "plan": {"params": plan.params,
                                             "opt_state": plan.opt_state,
                                             "total": plan.total}}
                parts = []

                def on_step(t, state, loss, ms, run=run, parts=parts,
                            mode=mode, steps=steps):
                    lay = layout_of(state.model)
                    whole = [_device_digest(torch, p) for n, p in
                             state.model.named_parameters()
                             if not lay.cuts[n]]
                    run["steps"].append({
                        "loss": loss, "ms": ms, "whole": whole,
                        "ring": dict(overlap.RING_STATS)})
                    if mode == "fp32":
                        named = list(state.model.named_parameters())
                        parts.append({n: p.grad.to("cpu", copy=True)
                                      for n, p in named})
                        if t == steps - 1:
                            parts.append({n: p.detach().to("cpu", copy=True)
                                          for n, p in named})

                reset_launch_counts()
                overlap.reset_ring_stats()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state = _tp_run(torch, cfg, mode, ids, mesh, steps, on_step)
                run["run_s"] = time.perf_counter() - t0
                run["launches"] = {k.name: k.launches for k in KERNELS}
                run["peak"] = torch.cuda.max_memory_allocated()
                run["params_bytes"], run["moment_bytes"] = _fsdp_resident(
                    state)
                lay = layout_of(state.model)
                run["cut"] = len(lay.sharded())
                del state
                gc.collect()
                torch.cuda.empty_cache()
                if mode == "fp32":
                    # one rank's whole tree on the same batch, here
                    t0 = time.perf_counter()
                    init = _tp_init(torch, cfg, lay)
                    worst = []

                    def one_step(t, state, loss, ms, run=run, lay=lay,
                                 parts=parts, init=init, worst=worst,
                                 steps=steps):
                        named = dict(state.model.named_parameters())
                        # the worst (distance, leaf) of the cut leaves
                        # and of the whole ones
                        w = {"cut": (0.0, ""), "whole": (0.0, "")}
                        for n, part in parts[t].items():
                            ref = lay.take(n, named[n].grad)
                            err = float(torch.linalg.vector_norm(
                                part.cuda() - ref)) / max(float(
                                    torch.linalg.vector_norm(ref)), 1e-30)
                            kind = "cut" if lay.cuts[n] else "whole"
                            w[kind] = max(w[kind], (err, n))
                        worst.append(w)
                        run["steps"][t]["one_loss"] = loss
                        if t < steps - 1:
                            return
                        w = (0.0, "")
                        for n, part in parts[-1].items():
                            ref = lay.take(n, named[n].detach())
                            upd = float(torch.linalg.vector_norm(
                                ref - init[n].cuda()))
                            err = float(torch.linalg.vector_norm(
                                part.cuda() - ref)) / max(upd, 1e-30)
                            w = max(w, (err, n))
                        run["params"] = w

                    state = _tp_run(torch, cfg, mode, ids, None, steps,
                                    one_step)
                    run["worst"] = worst
                    run["one_s"] = time.perf_counter() - t0
                    del state, parts, init
                    gc.collect()
                    torch.cuda.empty_cache()
                result[f"{key}-{mode}"] = run
            dist.barrier()
        print("TP_RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _tp_init(torch, cfg, lay) -> dict:
    """This rank's part of every leaf of ``init_llama(cfg, SEED)``'s tree,
    on the host: where each update is measured from."""
    from move2kube_tpu_torch import init_llama

    model = init_llama(cfg, seed=SEED, device="cuda", dtype=torch.float32)
    out = {n: lay.take(n, p.detach()).cpu()
           for n, p in model.named_parameters()}
    del model
    return out


def tp_phase(torch) -> dict:
    """Item 9c on the one card: two ranks share ``cuda:0`` in a gloo world.
    (a) Llama-8B's widths cut to TP_LAYERS layers at tensor=2 (each rank
    16 query and 4 KV heads, its gate/up columns, its vocab rows of the
    embedding and the head), 1 row of TP_SEQ tokens, grad_accum TP_ACCUM,
    TP_STEPS steps under the bf16 policy and fp32; (b) the MoE Llama at
    Mixtral's widths cut to TP_MOE_LAYERS layer at expert=2 (4 experts a
    rank), TP_MOE_STEPS steps fp32. Gates: each rank's resident parameter
    and Adam moment bytes equal the memory plan's per-device ``params``
    and ``opt_state`` to the byte; after every step the leaves whole on
    both ranks have one digest on both ranks; in fp32 after every step
    each rank's gradient of every leaf, cut or whole, is its slice of
    one rank's on the same batch (TP_GRAD_REL of its norm) and the loss
    one rank's (TP_LOSS_REL), and after the last step each rank's every
    leaf is its slice of one rank's (TP_PARAM_REL of its update); each
    rank's flash launches are its passes x layers.
    Reports each rank's peak against the plan's, the step's wall time
    and the activation all-reduces' bytes and seconds (host copies and
    gloo apart). Returns both ranks' launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="m2kt-tp-")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("M2KT_") and k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               M2KT_LOCAL_WORLD=str(TP_RANKS), M2KT_DIST_TIMEOUT_S="300")
    try:
        ranks = [_Child(f"tp rank {r}", [
            sys.executable, os.path.join(here, "chip_smoke.py"),
            "--tp-rank", os.path.join(work, "rank")],
            dict(env, M2KT_LOCAL_RANK=str(r)), here)
            for r in range(TP_RANKS)]
        rcs = []
        for child in ranks:
            rcs.append(child.finish(TP_CHILD_TIMEOUT_S if not any(rcs)
                                    else 30))
        if any(rcs):
            raise RuntimeError(f"tp: ranks exited {rcs}")
        res = [json.loads(next(x for x in c.lines if x.startswith(
            "TP_RESULT ")).split(" ", 1)[1]) for c in ranks]
        cfgs = _tp_cfgs()
        launches = {}
        for run in res[0]:
            key = run.split("-")[0]
            cfg, axes, steps, _ = cfgs[key]
            want = _want_train_launches(steps * TP_ACCUM, cfg.num_layers)
            plan = res[0][run]["plan"]
            for r, doc in enumerate(res):
                d = doc[run]
                if (d["params_bytes"], d["moment_bytes"]) != (
                        plan["params"], plan["opt_state"]):
                    raise RuntimeError(
                        f"tp: rank {r} {run} holds {d['params_bytes']} B of "
                        f"parameters and {d['moment_bytes']} B of Adam "
                        f"moments; the plan at {axes} says {plan['params']} "
                        f"and {plan['opt_state']}")
                _check_launches(f"tp: rank {r} {run}", d["launches"], want)
                for name, n in d["launches"].items():
                    launches[name] = launches.get(name, 0) + n
                for t, step in enumerate(d["steps"]):
                    if "one_loss" not in step:
                        continue
                    loss_err = abs(step["loss"] - step["one_loss"]) / abs(
                        step["one_loss"])
                    err, leaf = max(d["worst"][t].values())
                    if loss_err > TP_LOSS_REL or err > TP_GRAD_REL:
                        raise RuntimeError(
                            f"tp: rank {r} {run} step {t + 1}: loss "
                            f"{step['loss']} against one rank's "
                            f"{step['one_loss']} ({loss_err:.2e} > "
                            f"{TP_LOSS_REL}?), worst gradient {leaf} "
                            f"{err:.2e} of its norm (> {TP_GRAD_REL}?)")
                if "params" in d and d["params"][0] > TP_PARAM_REL:
                    raise RuntimeError(
                        f"tp: rank {r} {run}: after step {steps} "
                        f"{d['params'][1]} is {d['params'][0]:.2e} of its "
                        f"update from one rank's (> {TP_PARAM_REL})")
            for t in range(steps):
                digests = {tuple(doc[run]["steps"][t]["whole"])
                           for doc in res}
                if len(digests) != 1:
                    raise RuntimeError(f"tp: {run} step {t + 1}: the leaves "
                                       "whole on both ranks differ")
            steps_doc = res[0][run]["steps"]
            totals = [x["ring"] for x in steps_doc]
            r2 = {k: totals[1][k] - totals[0][k] for k in totals[0]}
            peaks = [doc[run]["peak"] for doc in res]
            gates = ""
            if "worst" in res[0][run]:
                gates = (
                    "; fp32 against one rank on the same batch: losses "
                    + ", ".join(f"{x['loss']:.6f}/{x['one_loss']:.6f}"
                                for x in steps_doc)
                    + "; the worst gradient a step, cut leaves "
                    + ", ".join("{1} {0:.2e}".format(*max(
                        doc[run]["worst"][t]["cut"] for doc in res))
                        for t in range(steps))
                    + ", whole leaves "
                    + ", ".join("{1} {0:.2e}".format(*max(
                        doc[run]["worst"][t]["whole"] for doc in res))
                        for t in range(steps))
                    + f" of its norm (gates {TP_LOSS_REL}, {TP_GRAD_REL}); "
                    "after the last step the worst leaf "
                    + "{1} {0:.2e} of its update".format(
                        *max(doc[run]["params"] for doc in res))
                    + f" (gate {TP_PARAM_REL})"
                    + "; the run " + ", ".join(
                        f"{doc[run]['run_s']:.1f}" for doc in res)
                    + " s a rank, one rank's run and the comparisons "
                    + ", ".join(f"{doc[run]['one_s']:.1f}" for doc in res)
                    + " s")
            log(f"tp: {run} {axes}, {steps} steps x {TP_ACCUM} microbatches "
                f"of 1 x {TP_SEQ}: {res[0][run]['cut']} leaves cut; step "
                "wall " + ", ".join(f"{x['ms']:.1f}" for x in steps_doc)
                + f" ms; rank 0 step 2: activation all-reduces "
                f"{r2['tp_calls']} calls {r2['tp_bytes'] / 1e9:.3f} GB (host "
                f"copies {r2['tp_copy_s'] * 1e3:.1f} ms, gloo hops and "
                f"additions {r2['tp_ring_s'] * 1e3:.1f} ms), gradient "
                f"all-reduces {r2['calls']} calls {r2['bytes'] / 1e9:.3f} GB "
                f"(host copies {r2['copy_s'] * 1e3:.1f} ms, gloo "
                f"{r2['ring_s'] * 1e3:.1f} ms), all-gathers {r2['ag_calls']}"
                f" ({r2['ag_copy_s'] * 1e3:.1f} + {r2['ag_ring_s'] * 1e3:.1f}"
                f" ms); peak {peaks} B a rank against the plan's "
                f"{plan['total']} B (drift "
                + ", ".join(f"{plan['total'] / p:.3f}" for p in peaks)
                + f"); each rank holds the plan's {plan['params']} B of "
                f"parameters and {plan['opt_state']} B of moments; whole "
                f"leaves one digest on both ranks after every step"
                f"{gates} ({CARD})")
        log(f"tp: phase {time.perf_counter() - t_phase:.1f} s ({CARD})")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs only on "
              "a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one cuBLAS workspace setting for this process and its children, set
    # before the first product: the emission phase holds a child's
    # deterministic training run to this process's bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_all = time.perf_counter()
    card_phase(torch)
    build_phase()
    flash_rows = flash_phase(torch)
    paged = paged_phase(torch)
    paged_int8 = paged_int8_phase(torch)
    lse_err = lse_phase(torch)
    bwd = bwd_phase(torch)
    gpt2_kernels = gpt2_kernels_phase(torch)
    parity_phase(torch)
    launches, model = slice_phase(torch)
    serve_model = _cut_depth(model, SERVE_LAYERS)
    async_launches = async_phase(torch, serve_model)
    for name in ("flash_fwd", "paged_decode"):
        launches[name] += async_launches[name]
    obs_serve, obs_int8 = obs_serve_phase(torch, model)
    int8_launches = int8_slice_phase(torch)
    for name in ("flash_fwd", "paged_decode"):
        launches[name] += obs_serve[name]
    launches["flash_fwd"] += obs_int8["flash_fwd"]
    for part in (obs_int8, async_launches):
        int8_launches["paged_decode_int8"] += part["paged_decode_int8"]
    t_fleet = time.perf_counter()
    fleet_parity_phase(torch)
    fleet_paged = fleet_slice_phase(torch, serve_model)
    log(f"fleet phases: {time.perf_counter() - t_fleet:.1f} s; the fleet "
        f"slice's three runs launched paged_decode {fleet_paged} times")
    t_router = time.perf_counter()
    fleet_router_parity_phase(torch)
    router = fleet_router_slice_phase(torch, model)
    # the fleet's engines and threads leave reference cycles that hold
    # the model: collect them, so the later phases' peaks are their own
    del model, serve_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fleet router phases: {time.perf_counter() - t_router:.1f} s")
    # the main path's launches: the serving slices, and the fleet's
    # traffic and quant audit run at full depth
    for name, n in router["traffic"].items():
        launches[name] += n
    for name, n in router["audit"].items():
        (int8_launches if name == "paged_decode_int8" else launches)[name] += n
    # the model families: GPT-2 served and trained, the MoE Llama served
    # and trained, and BERT, ResNet-50 and the UNet's train steps
    t_families = time.perf_counter()
    gpt2_parity_phase(torch)
    gpt2_serve, gpt2_serve8 = gpt2_slice_phase(torch)
    moe_serve = moe_slice_phase(torch)
    for part in (gpt2_serve, moe_serve):
        for name in ("flash_fwd", "paged_decode"):
            launches[name] += part[name]
    launches["flash_fwd"] += gpt2_serve8["flash_fwd"]
    int8_launches["paged_decode_int8"] += gpt2_serve8["paged_decode_int8"]
    train_parity_phase(torch)
    train_launches = train_slice_phase(torch)
    obs_train = obs_train_phase(torch)
    launches["flash_fwd"] += obs_train["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        train_launches[name] += obs_train[name]
    # the killed and resumed trainer, the uninterrupted one, and the
    # checkpoint served
    res = resilience_phase(torch)
    for name in ("flash_fwd", "paged_decode"):
        launches[name] += res[name]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        train_launches[name] += res[name]
    for part in (gpt2_train_phase(torch), moe_train_phase(torch)):
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            train_launches[name] += part[name]
    families_phase(torch)
    log(f"model family phases: {time.perf_counter() - t_families:.1f} s")
    # the emitted programs: trainer, full-depth server, train -> serve
    emitted = emit_phase(torch)
    for name in ("flash_fwd", "paged_decode"):
        launches[name] += emitted[name]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        train_launches[name] += emitted[name]
    # item 9a: two ranks of GPT-2 small on the one card
    mesh = mesh_phase(torch)
    # item 9b: two ZeRO-3 ranks of Llama-8B's width on the one card
    fsdp = fsdp_phase(torch)
    # item 9c: two tensor ranks, then two expert ranks, on the one card
    tp = tp_phase(torch)
    for part in (mesh, fsdp, tp):
        launches["flash_fwd"] += part["flash_fwd"]
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            train_launches[name] += part[name]
    main_flash = flash_rows[-1]  # s=2048, the longest prefill bucket
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "move2kube_tpu/ops/attention.py:302",
         "launches": launches["flash_fwd"],
         "max_abs_err": max([r["err"] for r in flash_rows]
                            + [lse_err, bwd["flash_fwd"]["err"],
                               gpt2_kernels["flash_fwd"]["err"],
                               gpt2_kernels["bwd"]["flash_fwd"]["err"]]),
         "ms": main_flash["ms"], "plain_ms": main_flash["plain_ms"],
         "bound_ms": main_flash["bound_ms"],
         "bound_by": main_flash["bound_by"],
         "library_ms": main_flash["library_ms"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/paged_decode.cu",
         "replaces": "move2kube_tpu/ops/attention.py:763",
         "launches": launches["paged_decode"],
         "max_abs_err": max(paged["err"],
                            gpt2_kernels["paged_decode"]["err"]),
         "ms": paged["ms"],
         "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
         "bound_by": paged["bound_by"], "library_ms": None},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/paged_decode_int8.cu",
         "replaces": "move2kube_tpu/ops/attention.py:878",
         "launches": int8_launches["paged_decode_int8"],
         "max_abs_err": max(paged_int8["err"],
                            gpt2_kernels["paged_decode_int8"]["err"]),
         "ms": paged_int8["ms"],
         "plain_ms": paged_int8["plain_ms"],
         "bound_ms": paged_int8["bound_ms"],
         "bound_by": paged_int8["bound_by"], "library_ms": None},
    ]
    for name, line in (("flash_bwd_dq", 439), ("flash_bwd_dkv", 487)):
        row = bwd[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"move2kube_tpu_torch/csrc/{name}.cu",
             "replaces": f"move2kube_tpu/ops/attention.py:{line}",
             "launches": train_launches[name],
             "max_abs_err": max(row["err"], gpt2_kernels["bwd"][name]["err"]),
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]})
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--resilience-child"]:
        sys.exit(resilience_child())
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_child())
    if sys.argv[1:2] == ["--fsdp-rank"]:
        sys.exit(fsdp_rank_child())
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_child())
    sys.exit(main())
