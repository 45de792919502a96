"""Attention for the port: flash forward and backward, and paged decode
over fp/bf16 or int8 page pools.

Each public function here has hand-written CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu``, ``csrc/flash_bwd_dkv.cu``,
``csrc/paged_decode.cu``, ``csrc/paged_decode_int8.cu``) and a plain
PyTorch version of the same function beside it. The choice is made by
where the tensors lie, and by nothing else: CPU tensors take the plain
version (the tests compare it with the JAX package), CUDA tensors launch
the kernel or raise. There is no fallback from a CUDA tensor to the plain
version.

Layouts are the JAX package's (``move2kube_tpu/ops/attention.py``):
``[batch, seq, heads, head_dim]`` for flash, ``[batch, heads, head_dim]``
queries over ``[num_pages, block_size, kv_heads, head_dim]`` pages for
decode. The flash logsumexp residual is fp32 ``[batch, heads, seq]`` (the
TPU kernels broadcast it over 128 lanes; that is a TPU tiling artefact).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from move2kube_tpu_torch.ops._build import FLOAT, INT, PTR, CudaKernel

_NEG_INF = -1e30

FLASH_FWD = CudaKernel(
    "flash_fwd", "m2kt_flash_fwd",
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT,
     INT, PTR])
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", "m2kt_flash_bwd_dq",
    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT,
     FLOAT, INT, INT, PTR])
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv", "m2kt_flash_bwd_dkv",
    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
     INT, FLOAT, INT, INT, PTR])
PAGED_DECODE = CudaKernel(
    "paged_decode", "m2kt_paged_decode",
    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT,
     INT, FLOAT, INT, INT, PTR])
PAGED_DECODE_INT8 = CudaKernel(
    "paged_decode_int8", "m2kt_paged_decode_int8",
    [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
     INT, INT, INT, FLOAT, INT, INT, PTR])
KERNELS = (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV, PAGED_DECODE,
           PAGED_DECODE_INT8)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# the cost model's view of the kernels (obs/costmodel.py). torch's
# FlopCounterMode sees the plain versions' einsums on the CPU but nothing
# of a ctypes launch, so each wrapper that launches adds its plain
# version's FLOPs, and the bytes it moves (each input read once, each
# output written once), to every count open in the process: the autograd
# engine launches the backward kernels from its own thread
_COST_SINKS: list[dict] = []
_COST_LOCK = threading.Lock()


@contextlib.contextmanager
def count_kernel_cost():
    """Open a count of the kernels' work: yields ``{"flops", "bytes"}``,
    which every kernel launched while it is open adds to."""
    sink = {"flops": 0, "bytes": 0}
    with _COST_LOCK:
        _COST_SINKS.append(sink)
    try:
        yield sink
    finally:
        with _COST_LOCK:
            _COST_SINKS.remove(sink)


def _note_cost(flops: int, *tensors) -> None:
    if not _COST_SINKS:
        return
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    with _COST_LOCK:
        for sink in _COST_SINKS:
            sink["flops"] += flops
            sink["bytes"] += nbytes


def flash_fwd_flops(b: int, s: int, sk: int, h: int, d: int) -> int:
    """FLOPs of the flash forward as its plain version counts them: the
    scores and the P.V products over every (query, key) pair of each
    head, masked or not (with or without the logsumexp)."""
    return 4 * b * h * s * sk * d


def flash_bwd_flops(b: int, s: int, sk: int, h: int, d: int
                    ) -> tuple[int, int]:
    """FLOPs of the flash backward's two kernels as the plain version
    counts them: its five products over every (query, key) pair of each
    head (P recomputed, dO.V^T, dq, dk, dv). P and dO.V^T, which the plain
    version computes once for both gradients, are put with dq; ``(dq's,
    dk and dv's)``."""
    unit = 2 * b * h * s * sk * d
    return 3 * unit, 2 * unit


def paged_decode_flops(b: int, h: int, max_blocks: int, block_size: int,
                       d: int) -> int:
    """FLOPs of a paged decode call as its plain version counts them (fp
    or int8 pages): the scores and the P.V products over every position
    the block tables span, ``max_blocks * block_size``, valid or not."""
    return 4 * b * h * max_blocks * block_size * d


def _kernel_args_ok(name: str, tensors: dict, dtype, d: int) -> None:
    """Raise on what the CUDA kernels do not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported by the CUDA "
                        f"kernel (fp32 or bf16)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not supported by the CUDA "
                         f"kernel ({_HEAD_DIMS})")
    dev = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}; every "
                             "operand must be on the same CUDA device")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _same_dtype(name: str, dtype, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, q is {dtype}; the "
                            "CUDA kernel takes one type")


def _stream_args(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None else (
        torch.cuda.current_device())
    return dev, torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------
# flash attention forward
# --------------------------------------------------------------------------


def _repeat_kv(t: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: ``jnp.repeat(t, rep, axis=2)`` — query head i reads KV head
    i // rep."""
    return t if rep == 1 else t.repeat_interleave(rep, dim=2)


def _scores(q, k, causal: bool, scale: float):
    """Scaled scores ``[b, h, s, sk]`` in fp32 over K repeated up to q's
    heads, masked positions at -1e30 (the JAX package's order: product in
    the input type, then fp32, then the scale)."""
    k = _repeat_kv(k, q.shape[2] // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, _NEG_INF))
    return s


def reference_attention(q, k, v, causal: bool, scale: float):
    """Plain version of the flash kernel (``_reference_attention`` in the
    JAX package): scores in the input type, softmax in fp32, probabilities
    cast to v's type for the PV product. ``k``/``v`` may carry fewer heads
    than ``q`` (GQA) and are repeated up to it."""
    return _weighted_values(_scores(q, k, causal, scale), v)


def _weighted_values(s, v):
    p = torch.softmax(s, dim=-1).to(v.dtype)
    v = _repeat_kv(v, s.shape[1] // v.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def reference_attention_abs_v(q, k, v, causal: bool, scale: float):
    """``P . |V|`` in fp32, ``[b, s, h, d]``: the probabilities of
    :func:`reference_attention` (the same ``_scores`` and GQA repeat)
    against the magnitudes of V. Rounding each probability to bf16 before
    the P.V product, as the tensor-core kernel and the TPU kernel on its
    MXU do, moves output i by at most ``2**-8 * (P . |V|)_i``."""
    return _weighted_values(_scores(q.float(), k.float(), causal, scale),
                            v.float().abs())


def reference_attention_lse(q, k, v, causal: bool, scale: float):
    """:func:`reference_attention` and its residual: ``(o, lse)`` with
    ``lse`` the fp32 logsumexp of each row's scaled scores, ``[b, h, s]``
    (what ``_flash_kernel`` writes for the backward)."""
    s = _scores(q, k, causal, scale)
    return _weighted_values(s, v), torch.logsumexp(s, dim=-1)


def _bwd_probs(q, k, v, o, lse, g, causal: bool, scale: float):
    """The backward's fp32 intermediates: ``p = exp(q.k^T * scale - lse)``
    and ``ds = p * (dO.v^T - delta)`` (``[b, h, s, sk]``), with q, dO and
    K repeated up to q's heads in fp32."""
    rep = q.shape[2] // k.shape[2]
    qf, gf = q.float(), g.float()
    kf = _repeat_kv(k.float(), rep)
    vf = _repeat_kv(v.float(), rep)
    p = torch.exp(_scores(qf, k.float(), causal, scale) - lse[..., None])
    delta = (gf * o.float()).sum(-1).transpose(1, 2)  # [b, h, s]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    return p, ds, qf, kf, gf


def _group_sum(t, kvh: int):
    """``[b, sk, h, d]`` summed over each GQA group to ``[b, sk, kvh, d]``
    (the VJP of repeating K/V)."""
    b, sk, h, d = t.shape
    return t.reshape(b, sk, kvh, h // kvh, d).sum(3)


def flash_attention_bwd_reference(q, k, v, o, lse, g, causal: bool,
                                  scale: float):
    """Plain version of the backward kernels (``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``): ``p = exp(q.k^T * scale - lse)`` recomputed
    from the forward's logsumexp, ``delta = rowsum(dO * O)``, ``ds = p *
    (dO.v^T - delta)``, ``dq = scale * ds.k``, ``dk = scale * ds^T.q``,
    ``dv = p^T.dO``, all in fp32. ``dk``/``dv`` come back at K/V's own head
    count, summed over each GQA group (the VJP of repeating K/V). Returns
    ``(dq, dk, dv)`` in the inputs' types."""
    kvh = k.shape[2]
    p, ds, qf, kf, gf = _bwd_probs(q, k, v, o, lse, g, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale, kvh)
    dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p, gf), kvh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_abs_terms(q, k, v, o, lse, g, causal: bool,
                                  scale: float):
    """The magnitudes behind each gradient of
    :func:`flash_attention_bwd_reference`, in fp32: ``(scale * |ds|.|k|,
    scale * |ds|^T.|q|, |p|^T.|dO|)`` at dq's, dk's and dv's shapes (the
    last two summed over each GQA group). Rounding ``ds`` and ``p`` to bf16
    before the products that make dq, dk and dv, as the tensor-core
    kernels and the TPU kernels on their MXU do, moves each gradient by at
    most ``2**-8`` times its term."""
    kvh = k.shape[2]
    p, ds, qf, kf, gf = _bwd_probs(q, k, v, o, lse, g, causal, scale)
    ds = ds.abs()
    t_dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf.abs()) * scale
    t_dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", ds, qf.abs()) * scale,
                      kvh)
    t_dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p.abs(), gf.abs()),
                      kvh)
    return t_dq, t_dk, t_dv


def _rows_aligned(name: str, **tensors) -> None:
    """Raise unless each tensor starts on a 16-byte aligned address with its
    rows a multiple of 16 bytes apart: what a TMA tensor map (the bf16
    kernels) and 16-byte vector loads (the fp32 ones) need."""
    for key, t in tensors.items():
        if t.data_ptr() % 16 or (t.stride(1) * t.element_size()) % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte aligned "
                             "address with rows a multiple of 16 bytes apart")


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float, want_lse: bool):
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    _kernel_args_ok("flash_attention", {"q": q, "k": k, "v": v}, q.dtype, d)
    _same_dtype("flash_attention", q.dtype, k=k, v=v)
    out = torch.empty_like(q)
    _rows_aligned("flash_attention", q=q, k=k, v=v, o=out)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if want_lse else None)
    if s == 0 or b * h == 0:
        return out, lse
    dev, stream = _stream_args(q)
    FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr() if want_lse else None,
                     b, s, sk, h, kvh, d, int(causal), float(scale),
                     _DTYPE_CODES[q.dtype], dev, stream)
    _note_cost(flash_fwd_flops(b, s, sk, h, d), q, k, v, out, lse)
    return out, lse


def flash_bwd_delta(o, g):
    """``delta = rowsum(dO * O)`` in fp32, ``[b, h, s]``: computed outside
    the backward kernels, as the JAX package does (attention.py:561-565)."""
    return (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_args_ok(q, k, v, g, lse, delta) -> None:
    b, s, h, d = q.shape
    _kernel_args_ok("flash_attention backward",
                    {"q": q, "k": k, "v": v, "dO": g, "lse": lse,
                     "delta": delta}, q.dtype, d)
    _same_dtype("flash_attention backward", q.dtype, k=k, v=v, dO=g)
    for key, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, s):
            raise ValueError(f"flash_attention backward: {key} must be fp32 "
                             f"[b, h, s] = {(b, h, s)}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _bwd_common(q, k, causal: bool, scale: float):
    b, s, h, d = q.shape
    dev, stream = _stream_args(q)
    return (b, s, k.shape[1], h, k.shape[2], d, int(causal), float(scale),
            _DTYPE_CODES[q.dtype], dev, stream)


def flash_bwd_dq(q, k, v, g, lse, delta, causal: bool, scale: float):
    """dq from ``csrc/flash_bwd_dq.cu`` (CUDA tensors only; ``delta`` from
    :func:`flash_bwd_delta`)."""
    _bwd_args_ok(q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    _rows_aligned("flash_attention backward", q=q, k=k, v=v, dO=g, dq=dq)
    if q.numel():
        FLASH_BWD_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(), *_bwd_common(q, k, causal, scale))
        b, s, h, d = q.shape
        _note_cost(flash_bwd_flops(b, s, k.shape[1], h, d)[0],
                   q, k, v, g, lse, delta, dq)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal: bool, scale: float):
    """``(dk, dv)`` at K/V's head count from ``csrc/flash_bwd_dkv.cu``
    (CUDA tensors only)."""
    _bwd_args_ok(q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _rows_aligned("flash_attention backward", q=q, k=k, v=v, dO=g, dk=dk,
                  dv=dv)
    if not q.numel():
        return dk.zero_(), dv.zero_()
    if k.numel():
        FLASH_BWD_DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(),
                             *_bwd_common(q, k, causal, scale))
        b, s, h, d = q.shape
        _note_cost(flash_bwd_flops(b, s, k.shape[1], h, d)[1],
                   q, k, v, g, lse, delta, dk, dv)
    return dk, dv


def _on(name: str, t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: no implementation on {t.device}")


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        want_lse: bool = True):
    """Forward with its residual: ``(o, lse)``, ``lse`` fp32 ``[b, h, s]``
    (``None`` when not ``want_lse``: the kernel then writes none). CUDA
    tensors launch ``csrc/flash_fwd.cu``; CPU tensors take
    :func:`reference_attention_lse`."""
    if _on("flash_attention", q) == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, scale, want_lse)
    if want_lse:
        return reference_attention_lse(q, k, v, causal, scale)
    return reference_attention(q, k, v, causal, scale), None


def flash_attention_bwd(q, k, v, o, lse, g, causal: bool, scale: float):
    """Gradients ``(dq, dk, dv)`` of flash attention from the forward's
    residuals (``o``, ``lse``) and the output's gradient ``g``; ``dk``/
    ``dv`` at K/V's head count. CUDA tensors launch
    ``csrc/flash_bwd_dq.cu`` then ``csrc/flash_bwd_dkv.cu``; CPU tensors
    take :func:`flash_attention_bwd_reference`."""
    if _on("flash_attention backward", q) == "cuda":
        delta = flash_bwd_delta(o, g)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, causal, scale)
        return (dq, *flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale))
    return flash_attention_bwd_reference(q, k, v, o, lse, g, causal, scale)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward saves ``q, k, v, o,
    lse``; the backward recomputes the probabilities from ``lse`` (the
    JAX package's ``_flash_attention_diff`` custom VJP, without its
    fallbacks)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """Fused attention forward, differentiable. ``q``: ``[b, s, h, d]``;
    ``k``/``v``: ``[b, sk, kvh, d]`` with ``kvh`` dividing ``h`` (query
    head i reads KV head ``i // (h // kvh)``, as repeating K/V up to ``h``
    heads would). Causal masking compares absolute positions (query i sees
    keys <= i). Any ``s`` and ``sk``: the kernels mask ragged tails
    themselves.

    When autograd records (grad enabled and an input requires grad) the
    call goes through :class:`FlashAttention`, whose forward also writes
    the logsumexp and whose backward runs the backward kernels; otherwise
    (serving, ``torch.inference_mode()``) it is one forward launch with no
    residual. CUDA tensors launch the kernels; CPU tensors take the plain
    versions."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or (
            k.shape[3] != q.shape[3]) or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal, scale, want_lse=False)[0]


# --------------------------------------------------------------------------
# paged decode attention
# --------------------------------------------------------------------------


def quantize_kv_rows(x):
    """Symmetric per-(token, kv-head) int8 quantization of K/V rows (the
    JAX package's ``quantize_kv_rows``, the same operations in the same
    order, so the two give the same bits).

    ``x``: ``[..., kv_heads, head_dim]`` floating K or V. Returns ``(q,
    scale)``: ``q`` int8 of the same shape, ``scale`` fp32 ``[...,
    kv_heads]`` with ``q * scale[..., None]`` reconstructing ``x``. One
    scale per written row keeps a decode append O(1): a new token never
    re-quantizes the tokens already in its page."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def paged_decode_reference(q, k_pages, v_pages, block_tables, seq_lens,
                           scale: float):
    """Plain version of the paged-decode kernel (the fp branch of
    ``_paged_decode_reference`` in the JAX package): gather each sequence's
    pages into a contiguous context, repeat K/V up to the query heads,
    mask positions at or past ``seq_lens``."""
    b, h, d = q.shape
    _, block_size, kvh, _ = k_pages.shape
    mb = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, mb * block_size, kvh, d)
    v = v_pages[bt].reshape(b, mb * block_size, kvh, d)
    rep = h // kvh
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    valid = (torch.arange(mb * block_size, device=q.device)[None, None, :]
             < seq_lens.to(q.device)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(v.dtype), v)


def paged_decode_int8_reference(q, k_pages, v_pages, k_scale, v_scale,
                                block_tables, seq_lens, scale: float):
    """Plain version of the int8 paged-decode kernel (the int8 branch of
    ``_paged_decode_reference`` in the JAX package): gather the int8 pages
    and their row scales, and fold the scales in after the contractions,
    as a row scale is constant over head_dim:
    ``s = ((q * scale) . k8) * k_scale`` per score, and
    ``o = sum_s (p * v_scale) * v8``. No fp context is materialised;
    GQA is a batched product over the KV-head axis. Returns ``q.dtype``."""
    b, h, d = q.shape
    _, block_size, kvh, _ = k_pages.shape
    mb = block_tables.shape[1]
    seq = mb * block_size
    rep = h // kvh
    bt = block_tables.long()
    k8 = k_pages[bt].reshape(b, seq, kvh, d)
    v8 = v_pages[bt].reshape(b, seq, kvh, d)
    ks = k_scale[bt].reshape(b, seq, kvh)
    vs = v_scale[bt].reshape(b, seq, kvh)
    qh = (q.float() * scale).reshape(b, kvh, rep, d)
    s = torch.einsum("bkrd,bskd->bkrs", qh, k8.float())
    s = s * ks.transpose(1, 2)[:, :, None, :]
    valid = (torch.arange(seq, device=q.device)[None, None, None, :]
             < seq_lens.to(q.device)[:, None, None, None])
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    pv = torch.einsum("bkrs,bskd->bkrd",
                      p * vs.transpose(1, 2)[:, :, None, :], v8.float())
    return pv.reshape(b, h, d).to(q.dtype)


# The paged-decode kernels cut each sequence's context into splits of whole
# pages over the grid (split, KV head, sequence), sized from max_blocks
# (csrc/paged_split.cuh). Splits of up to PAGED_SPLIT_TOKENS tokens (of 64,
# 128 and 256, the fastest at chip_smoke.py's paged batch on an H100),
# halved (down to _SPLIT_MIN_TOKENS) while the grid holds fewer than
# _SPLIT_BLOCKS_PER_SM blocks an SM.
PAGED_SPLIT_TOKENS = 128
_SPLIT_MIN_TOKENS = 32
_SPLIT_BLOCKS_PER_SM = 3


def paged_split_plan(b: int, kvh: int, max_blocks: int, block_size: int,
                     sm_count: int,
                     split_tokens: int = PAGED_SPLIT_TOKENS
                     ) -> tuple[int, int]:
    """``(pages_per_split, n_split)`` for the paged-decode kernels' grid of
    ``n_split x kvh x b`` blocks: whole pages a split (so a multiple of 8
    tokens), ``n_split * pages_per_split >= max_blocks``. A function of
    host integers only: it reads no ``seq_lens``, so a decode step gains no
    device-to-host sync; blocks whose split starts past their sequence's
    length return at once."""
    pps = max(1, split_tokens // block_size)
    target = _SPLIT_BLOCKS_PER_SM * sm_count
    while (pps > 1 and (pps // 2) * block_size >= _SPLIT_MIN_TOKENS
           and b * kvh * -(-max_blocks // pps) < target):
        pps //= 2
    pps = min(pps, max(max_blocks, 1))
    return pps, max(1, -(-max_blocks // pps))


_cached_plan = functools.lru_cache(maxsize=256)(paged_split_plan)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _paged_geometry_ok(name: str, h: int, kvh: int, block_size: int,
                       block_tables, seq_lens, **pools) -> None:
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and seq_lens must be int32")
    if block_size % 8:
        raise ValueError(f"{name}: the CUDA kernel needs block_size % 8 == "
                         f"0 (got {block_size})")
    if h // kvh not in (1, 2, 4, 8):
        raise ValueError(f"{name}: the CUDA kernel serves 1, 2, 4 or 8 query"
                         f" heads per KV head (got {h // kvh})")
    # the kernel copies 16 bytes of a row at a time
    for key, t in pools.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _paged_launch(kernel, q, pools, block_tables, seq_lens, block_size: int,
                  kvh: int, scale: float, split_tokens: int):
    """Plan the split, allocate the output and the split workspace (one
    ``torch.empty``, none when there is one split) and launch ``kernel``'s
    C entry point once: its split pass, then its merge pass."""
    b, h, d = q.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    dev, stream = _stream_args(q)
    mb = block_tables.shape[1]
    pps, n_split = _cached_plan(b, kvh, mb, block_size, _sm_count(dev),
                                split_tokens)
    ws = (torch.empty(b * n_split * h * (d + 2), dtype=torch.float32,
                      device=q.device)
          if n_split > 1 else None)
    kernel.launch(q.data_ptr(), *(t.data_ptr() for t in pools),
                  block_tables.data_ptr(), seq_lens.data_ptr(),
                  out.data_ptr(), None if ws is None else ws.data_ptr(), b, h,
                  kvh, d, block_size, mb, pps, n_split, float(scale),
                  _DTYPE_CODES[q.dtype], dev, stream)
    if _COST_SINKS:
        # the rows of every page the block tables name, as the plain
        # version gathers them (an upper bound: the kernel stops at
        # seq_lens)
        rows = [t[:1].expand(b * mb, *t.shape[1:]) for t in pools]
        _note_cost(paged_decode_flops(b, h, mb, block_size, d), q, *rows,
                   block_tables, seq_lens, out)
    return out


def _paged_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                       scale: float, split_tokens: int = PAGED_SPLIT_TOKENS):
    h, d = q.shape[1:]
    _, block_size, kvh, _ = k_pages.shape
    _kernel_args_ok("paged_decode_attention",
                    {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                     "block_tables": block_tables, "seq_lens": seq_lens},
                    q.dtype, d)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q and the page pools must "
                        f"share one dtype (q {q.dtype}, pages "
                        f"{k_pages.dtype})")
    _paged_geometry_ok("paged_decode_attention", h, kvh, block_size,
                       block_tables, seq_lens, k_pages=k_pages,
                       v_pages=v_pages)
    return _paged_launch(PAGED_DECODE, q, (k_pages, v_pages), block_tables,
                         seq_lens, block_size, kvh, scale, split_tokens)


def _paged_decode_int8_cuda(q, k_pages, v_pages, k_scale, v_scale,
                            block_tables, seq_lens, scale: float,
                            split_tokens: int = PAGED_SPLIT_TOKENS):
    name = "paged_decode_attention (int8)"
    h, d = q.shape[1:]
    _, block_size, kvh, _ = k_pages.shape
    _kernel_args_ok(name, {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                           "k_scale": k_scale, "v_scale": v_scale,
                           "block_tables": block_tables,
                           "seq_lens": seq_lens}, q.dtype, d)
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"{name}: the page pools must be int8 (got "
                        f"{k_pages.dtype}, {v_pages.dtype})")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: the scale pools must be fp32 (got "
                        f"{k_scale.dtype}, {v_scale.dtype})")
    _paged_geometry_ok(name, h, kvh, block_size, block_tables, seq_lens,
                       k_pages=k_pages, v_pages=v_pages)
    return _paged_launch(PAGED_DECODE_INT8, q,
                         (k_pages, v_pages, k_scale, v_scale), block_tables,
                         seq_lens, block_size, kvh, scale, split_tokens)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale: float | None = None, k_scale=None,
                           v_scale=None):
    """Decode-step attention against a paged KV cache. GQA-aware.

    - ``q``: ``[batch, heads, head_dim]``, one new query token per slot
    - ``k_pages``/``v_pages``: ``[num_pages, block_size, kv_heads,
      head_dim]``
    - ``block_tables``: ``[batch, max_pages_per_seq]`` int32 page indices
      (unused entries point at page 0, which is never read)
    - ``seq_lens``: ``[batch]`` int32 valid-token counts, INCLUDING the
      token being decoded (its K/V is already in the cache)
    - ``k_scale``/``v_scale``: ``[num_pages, block_size, kv_heads]`` fp32
      row scales of int8 page pools (both or neither); the result is in
      ``q``'s type

    CUDA tensors launch ``csrc/paged_decode.cu`` (fp pools) or
    ``csrc/paged_decode_int8.cu`` (int8 pools with their scales), split
    over the sequence by :func:`paged_split_plan` and merged in a fixed
    order, so two calls give the same bits; CPU tensors take
    :func:`paged_decode_reference` or :func:`paged_decode_int8_reference`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.ndim != 3 or k_pages.shape != v_pages.shape or (
            k_pages.shape[3] != q.shape[2]) or q.shape[1] % k_pages.shape[2]:
        raise ValueError(
            f"paged_decode_attention: bad shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("paged_decode_attention: pass both k_scale and "
                         "v_scale, or neither")
    if quantized and not (k_scale.shape == v_scale.shape
                          == k_pages.shape[:3]):
        raise ValueError(
            f"paged_decode_attention: scale pools {tuple(k_scale.shape)} / "
            f"{tuple(v_scale.shape)} do not match pages "
            f"{tuple(k_pages.shape)}")
    on = _on("paged_decode_attention", q)
    if quantized:
        args = (q, k_pages, v_pages, k_scale, v_scale, block_tables,
                seq_lens, scale)
        return (_paged_decode_int8_cuda(*args) if on == "cuda"
                else paged_decode_int8_reference(*args))
    args = (q, k_pages, v_pages, block_tables, seq_lens, scale)
    return (_paged_decode_cuda(*args) if on == "cuda"
            else paged_decode_reference(*args))
