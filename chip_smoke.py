#!/usr/bin/env python3
"""Card-side check of the PyTorch/CUDA port (``move2kube_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name
2. build: both CUDA kernels from ``move2kube_tpu_torch/csrc`` with nvcc
   for sm_90a, in parallel
3. each kernel against its plain PyTorch version on the card, at the
   slice's shapes in bf16, with its time, its bound and (flash) the time
   of PyTorch's own ``scaled_dot_product_attention`` as a yardstick
4. engine parity at Llama-8B width and 2 layers in fp32: the engine on
   the kernels against the same weights' plain dense path
5. the slice: full-depth Llama-8B in bf16 serving 16 requests on the
   engine; the kernels' launch counts show every prefill and decode step
   went through them
6. one JSON line with every kernel's numbers, then the result line

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
# engine parity, fp32: logits of O(1) through 2 layers of width 4096 with
# the attention in the kernels vs einsums (both fp32, TF32 off), summed
# in other orders
FP32_ENGINE_ATOL = 2e-3
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
    from move2kube_tpu_torch.ops.attention import KERNELS

    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS)
    log(f"build: {len(KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


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
        err = bf16_check(torch, f"flash s={s}", out, ref)
        sets = _copies(torch, (q, k, v))
        iters = 50 if s <= 1000 else 20
        ms = cuda_ms(torch, lambda q_, k_, v_: att.flash_attention(
            q_, k_, v_, causal=True), sets, iters)
        plain_ms = cuda_ms(torch, lambda q_, k_, v_: att.reference_attention(
            q_, k_, v_, True, scale), sets, max(5, iters // 4))
        # PyTorch's fused attention on head-major, GQA-repeated copies
        # (made outside the timing): a yardstick the port never calls
        lib_sets = [tuple(t.repeat_interleave(h // t.shape[2], dim=2)
                          .transpose(1, 2).contiguous() for t in ts)
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
            f"max_abs_err {err:.3e} (within {BF16_ATOL} + {BF16_RTOL} |x| "
            f"of the plain result rounded to bf16) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del sets, lib_sets
    return rows


def paged_phase(torch):
    import numpy as np

    from move2kube_tpu_torch.ops import attention as att

    b, h, kvh, d, bs, max_seq = 8, 32, 8, 128, 16, 2048
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
                                     sl, d ** -0.5)
    # the null page holds NaN for the kernel: it must never be read
    kp[0] = float("nan")
    vp[0] = float("nan")
    out = att.paged_decode_attention(q, kp, vp, bt, sl)
    err = bf16_check(torch, "paged_decode (NaN in the null page)", out, ref)
    sets = _copies(torch, (q, kp, vp, bt, sl))
    ms = cuda_ms(torch, att.paged_decode_attention, sets, 200)
    kp0 = [(a, k.clone(), v.clone(), t, n) for a, k, v, t, n in sets[:2]]
    for _, k, v, _, _ in kp0:
        k[0] = 0
        v[0] = 0
    plain_ms = cuda_ms(torch, lambda *a: att.paged_decode_reference(
        *a, d ** -0.5), kp0, 20)
    tokens = int(seq_lens.sum())
    nbytes = (tokens * kvh * d * 2 * 2 + 2 * q.numel() * 2
              + tables.nbytes + seq_lens.nbytes)
    ops = 4 * tokens * h * d
    t_ops = ops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_S * 1e3
    row = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"paged_decode b={b} h={h} kvh={kvh} d={d} bs={bs} seq_lens "
        f"{seq_lens.tolist()} bf16: max_abs_err {err:.3e} (within "
        f"{BF16_ATOL} + {BF16_RTOL} |x| of the plain result rounded to "
        f"bf16) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved)")
    return row


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
    del eng, model, plain
    torch.cuda.empty_cache()


def slice_phase(torch):
    import numpy as np

    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_8b,
        reset_launch_counts,
    )
    from move2kube_tpu_torch.ops.attention import FLASH_FWD, PAGED_DECODE

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(llama_8b(), attn_impl="flash")
    t0 = time.perf_counter()
    model = init_llama(cfg, seed=SEED, device="cuda").eval()
    torch.cuda.synchronize()
    log(f"slice: llama_8b, attn_impl='flash', bf16 weights drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    econf = EngineConfig(max_batch=8, max_seq=2048, block_size=16)
    # warm-up on its own engine: first-call costs stay out of the numbers
    ServingEngine(model, econf, device="cuda").run(
        [Request("warm", list(range(1, 65)), 4)])
    torch.cuda.synchronize()
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
    launches = {"flash_fwd": FLASH_FWD.launches,
                "paged_decode": PAGED_DECODE.launches}
    stats = eng.stats()
    if len(comps) != 16 or any(len(c.tokens) != 64 for c in comps):
        raise RuntimeError("slice: not every request completed with 64 "
                           "tokens")
    for rid, rows in eng.logit_log.items():
        if not all(np.isfinite(r).all() for r in rows):
            raise RuntimeError(f"slice: non-finite logits for {rid}")
    want = {"flash_fwd": cfg.num_layers * stats["prefills"],
            "paged_decode": cfg.num_layers * stats["decode_steps"]}
    if launches != want or stats["prefills"] != 16:
        raise RuntimeError(f"slice: launches {launches}, expected {want} "
                           f"({stats['prefills']} prefills, "
                           f"{stats['decode_steps']} decode steps)")
    generated = sum(len(c.tokens) for c in comps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"slice: 16 requests, prompts {sorted(lengths.tolist())}, 64 new "
        f"tokens each, max_batch 8: wall {wall:.3f} s, "
        f"{generated / wall:.1f} tokens/s overall, decode "
        f"{stats['decode_throughput_tokens_s']:.1f} tokens/s over "
        f"{stats['decode_steps']} steps "
        f"({stats['decode_time_s'] / stats['decode_steps'] * 1e3:.2f} "
        f"ms/step), {stats['prefills']} prefills in "
        f"{stats['prefill_time_s']:.3f} s, mean TTFT "
        f"{stats['ttft_mean_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f} "
        f"ms, all submitted at once), peak memory {peak:.2f} GiB")
    log(f"slice: launches {launches} = {cfg.num_layers} layers x "
        f"({stats['prefills']} prefills, {stats['decode_steps']} decode "
        "steps)")
    del eng
    profile_phase(torch, model, econf, rng)
    return launches


def _profiled(torch, label: str, fn) -> None:
    """Run ``fn`` under torch.profiler; print its wall time, the device's
    busy time (kernels on one stream do not overlap, so their times add
    up to it) and the kernels that took most of it. Host-side operator
    entries also carry their kernels' device time; only the kernels'
    own entries are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    log(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{sum(e.count for e in events)} kernels")
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def profile_phase(torch, model, econf, rng) -> None:
    """Where the slice's time goes: one prefill of a 1000-token prompt,
    then 4 decode steps at a full batch of 8 (prompts of 512)."""
    from move2kube_tpu_torch import Request, ServingEngine

    vocab = model.cfg.vocab_size
    eng = ServingEngine(model, dataclasses.replace(econf, admit_burst=0),
                        device="cuda")
    eng.submit(Request("long", rng.integers(1, vocab, size=1000).tolist(),
                       16))
    _profiled(torch, "prefill (1000 tokens, bucket 1024) + 1 decode step "
              "at 1 of 8 slots", eng.step)
    for i in range(7):
        eng.submit(Request(f"b{i}", rng.integers(1, vocab,
                                                 size=512).tolist(), 16))
    eng.step()  # admits the 7 (prefills) and decodes
    _profiled(torch, "4 decode steps at 8 of 8 slots",
              lambda: [eng.step() for _ in range(4)])


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
    parity_phase(torch)
    launches = slice_phase(torch)
    main_flash = flash_rows[-1]  # s=2048, the longest prefill bucket
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "move2kube_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "move2kube_tpu/ops/attention.py:302",
         "launches": launches["flash_fwd"],
         "max_abs_err": max(r["err"] for r in flash_rows),
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
    ]
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
