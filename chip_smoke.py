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
   the engine; the kernels' launch counts show every prefill and decode
   step went through them
6. the int8-kv serving slice: the same model and requests with int8
   weights and an int8 paged KV cache, every decode step's attention in
   the int8 kernel; its memory, and a profile of 4 decode steps beside
   the time the weights' dequantization takes a step
7. training parity at Llama-8B width and 2 layers in fp32: 3 steps of the
   LM train step with the attention in the kernels against the plain
   dense attention, from the same weights on the same batches; then the
   same in the bf16 policy, held to source/validate.py's gates
8. the training slice: Llama-8B widths cut to 8 layers, fp32 master
   weights, the bf16 policy, AdamW, remat, head-folded cross-entropy,
   batch 4 x 2048 tokens; 5 timed steps whose launch counts show every
   layer's forward, recompute and backward went through the kernels, and
   one step under the profiler
9. one JSON line with every kernel's numbers, then the result line

Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
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
H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet)
H100_BYTES_S = 3.35e12     # HBM3 (NVIDIA data sheet)
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_phase(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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


def flash_phase(torch):
    import torch.nn.functional as F

    from move2kube_tpu_torch.ops import attention as att

    b, h, kvh, d = 1, 32, 8, 128
    scale = d ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = []
    for s in (128, 1000, 2048):
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
        ms = cuda_ms(torch, lambda q_, k_, v_: att.flash_attention(
            q_, k_, v_, causal=True), sets, iters)
        plain_ms = cuda_ms(torch, lambda q_, k_, v_: att.reference_attention(
            q_, k_, v_, True, scale), sets, max(5, iters // 4))
        # PyTorch's fused attention on head-major, GQA-repeated copies
        # (made outside the timing): a yardstick the port never calls
        lib_sets = [tuple(_sdpa_layout(t, h).contiguous() for t in ts)
                    for ts in sets]
        library_ms = cuda_ms(
            torch, lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, is_causal=True), lib_sets, iters)
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
            f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s) plain "
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
    log(f"{label}: b=1 on the 2048-token sequence: split of {p1 * bs} "
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


def paged_phase(torch):
    from move2kube_tpu_torch.ops import attention as att

    b, h, kvh, d, bs, max_seq = 8, 32, 8, 128, 16, 2048
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

    def call(*a, split_tokens=None):
        if split_tokens is None:
            return att.paged_decode_attention(*a)
        return att._paged_decode_cuda(*a, scale, split_tokens)

    sets = _copies(torch, (q, kp, vp, bt, sl))
    long_row = int(seq_lens.argmax())
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
        f"{seq_lens.tolist()} bf16: max_abs_err {err:.3e} (within "
        f"{BF16_ATOL} + {BF16_RTOL} |x| of the plain result rounded to "
        f"bf16), the same bits over two launches; kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, {100 * row['bound_ms'] / ms:.1f}% of it)")
    return row


def paged_int8_phase(torch):
    """The int8 paged-decode kernel at paged_phase's batch: pools from
    ``quantize_kv_rows`` of random rows, a bf16 and an fp32 query, NaN
    scales and +-127 rows in the null page (the kernel must never read
    it; the plain version runs on a copy whose null page is zeroed, as
    0 * NaN is NaN in its fold), then a shared-prefix pair and a COW-copied
    page; the same bits over two launches; speed as paged_phase's."""
    from move2kube_tpu_torch.ops import attention as att
    from move2kube_tpu_torch.serving.kvcache import copy_page

    b, h, kvh, d, bs, max_seq = 8, 32, 8, 128, 16, 2048
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
    long_row = int(seq_lens.argmax())
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
        f"{seq_lens.tolist()} int8 pools: bf16 q max_abs_err {err:.3e} "
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


def bwd_phase(torch):
    """The backward kernels in bf16 at the training slice's attention shape
    against the plain backward by the backward rule (SDPA's backward's
    share of the same allowance beside theirs), bit-identical over two
    launches, each with its time, its bound, the plain backward's time and
    SDPA's backward as a yardstick; and the forward
    with its lse at the same shape, checked by the flash rule (SDPA's
    forward too) and timed beside SDPA's forward, with its bound."""
    import torch.nn.functional as F

    from move2kube_tpu_torch.ops import attention as att

    b, s, h, kvh, d = 4, 2048, 32, 8, 128
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


def _greedy_dense(torch, model, prompt, n):
    """Greedy continuation by full forwards of the plain dense path;
    returns the tokens and the logits rows each was argmaxed from."""
    toks, rows = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            logits = model(torch.tensor([toks], device="cuda"))[0, -1]
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
        b_t = got[rid]
        agree = 0
        while agree < min(len(a_t), len(b_t)) and a_t[agree] == b_t[agree]:
            agree += 1
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


def _serve_slice(torch, model, econf, label: str, decode_kernel: str):
    """The serving slices' run: a warm-up on its own engine (first-call
    costs stay out of the numbers), then 16 requests submitted at once
    (prompt lengths drawn from seed 2 in 64..1536, 64 new tokens each) on
    a fresh engine with every launch count set to 0 just before. Checks
    that every request completed with finite logits and that each layer
    launched ``flash_fwd`` once a prefill and ``decode_kernel`` once a
    decode step, and nothing else; prints the numbers, then profiles a
    prefill and 4 decode steps. Returns the launch counts and one decode
    step's profiled device busy time in ms."""
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
    rng = np.random.default_rng(SEED + 2)
    lengths = rng.integers(64, 1537, size=16)
    reqs = [Request(f"r{i}", rng.integers(1, cfg.vocab_size,
                                          size=int(n)).tolist(), 64)
            for i, n in enumerate(lengths)]
    eng = ServingEngine(model, econf, device="cuda")
    eng.capture_logits = True
    reset_launch_counts()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    stats = eng.stats()
    if len(comps) != 16 or any(len(c.tokens) != 64 for c in comps):
        raise RuntimeError(f"{label}: not every request completed with 64 "
                           "tokens")
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv_bytes = sum(t.numel() * t.element_size()
                   for pools in eng._cache.values()
                   if isinstance(pools, list) for t in pools)
    log(f"{label}: 16 requests, prompts {sorted(lengths.tolist())}, 64 new "
        f"tokens each, max_batch 8, quant {econf.quant}: wall {wall:.3f} s,"
        f" {generated / wall:.1f} tokens/s overall, decode "
        f"{stats['decode_throughput_tokens_s']:.1f} tokens/s over "
        f"{stats['decode_steps']} steps "
        f"({stats['decode_time_s'] / stats['decode_steps'] * 1e3:.2f} "
        f"ms/step), {stats['prefills']} prefills in "
        f"{stats['prefill_time_s']:.3f} s, mean TTFT "
        f"{stats['ttft_mean_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f} "
        f"ms, all submitted at once); resident parameters "
        f"{param_bytes(model) / 1e9:.3f} GB, KV pools {kv_bytes / 1e9:.3f} "
        f"GB, peak memory {peak:.2f} GiB")
    log(f"{label}: launches {launches} = {cfg.num_layers} layers x "
        f"({stats['prefills']} prefills, {stats['decode_steps']} decode "
        "steps)")
    del eng
    return launches, profile_phase(torch, model, econf, rng)


def slice_phase(torch):
    from move2kube_tpu_torch import EngineConfig, init_llama, llama_8b

    cfg = dataclasses.replace(llama_8b(), attn_impl="flash")
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    torch.cuda.synchronize()
    log(f"slice: llama_8b, attn_impl='flash', bf16 weights drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    return _serve_slice(torch, model, econf, "slice", "paged_decode")[0]


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
    launches, busy = _serve_slice(torch, model, econf, "int8 slice",
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


def _train_run(torch, cfg, policy_name, batches, remat=True,
               first_grads=None):
    """Steps of the LM train step on fresh fp32 master weights drawn from
    SEED, AdamW (lr 1e-4, weight decay 0.1); returns the state, the step
    function and the losses and grad norms (tensors). A dict passed as
    ``first_grads`` receives a copy of each parameter's first-step
    gradient."""
    from move2kube_tpu_torch import (
        TrainState,
        adamw,
        init_llama,
        instrument_optimizer,
        make_lm_train_step,
        policy,
    )

    pol = policy(policy_name)
    model = init_llama(cfg, seed=SEED, device="cuda", dtype=torch.float32)
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


def bf16_train_parity(torch, cfg, batches) -> None:
    """The same weights and batches in the bf16 policy: 3 steps with the
    flash kernels (the tensor-core forward, and the backward kernels
    reading its o and lse) against dense attention, held to
    source/validate.py's loss and grad-norm gates."""
    runs = {}
    for impl in ("flash", "dense"):
        state, _, losses, norms = _train_run(
            torch, dataclasses.replace(cfg, attn_impl=impl), "bf16", batches)
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
    log(f"train parity: llama_8b widths, 2 layers, bf16 policy, batch 2 x "
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
    t_all = time.perf_counter()
    card_phase(torch)
    build_phase()
    flash_rows = flash_phase(torch)
    paged = paged_phase(torch)
    paged_int8 = paged_int8_phase(torch)
    lse_err = lse_phase(torch)
    bwd = bwd_phase(torch)
    parity_phase(torch)
    launches = slice_phase(torch)
    int8_launches = int8_slice_phase(torch)
    train_parity_phase(torch)
    train_launches = train_slice_phase(torch)
    main_flash = flash_rows[-1]  # s=2048, the longest prefill bucket
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "move2kube_tpu/ops/attention.py:302",
         "launches": launches["flash_fwd"],
         "max_abs_err": max([r["err"] for r in flash_rows]
                            + [lse_err, bwd["flash_fwd"]["err"]]),
         "ms": main_flash["ms"], "plain_ms": main_flash["plain_ms"],
         "bound_ms": main_flash["bound_ms"],
         "bound_by": main_flash["bound_by"],
         "library_ms": main_flash["library_ms"]},
        {"name": "paged_decode", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/paged_decode.cu",
         "replaces": "move2kube_tpu/ops/attention.py:763",
         "launches": launches["paged_decode"],
         "max_abs_err": paged["err"], "ms": paged["ms"],
         "plain_ms": paged["plain_ms"], "bound_ms": paged["bound_ms"],
         "bound_by": paged["bound_by"], "library_ms": None},
        {"name": "paged_decode_int8", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/paged_decode_int8.cu",
         "replaces": "move2kube_tpu/ops/attention.py:878",
         "launches": int8_launches["paged_decode_int8"],
         "max_abs_err": paged_int8["err"], "ms": paged_int8["ms"],
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
             "launches": train_launches[name], "max_abs_err": row["err"],
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
    sys.exit(main())
