"""Attention for the port: flash forward and paged decode.

Each public function here has a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, ``csrc/paged_decode.cu``) and a plain PyTorch
version of the same function beside it. The choice is made by where the
tensors lie, and by nothing else: CPU tensors take the plain version (the
tests compare it with the JAX package), CUDA tensors launch the kernel or
raise. There is no fallback from a CUDA tensor to the plain version.

Layouts are the JAX package's (``move2kube_tpu/ops/attention.py``):
``[batch, seq, heads, head_dim]`` for flash, ``[batch, heads, head_dim]``
queries over ``[num_pages, block_size, kv_heads, head_dim]`` pages for
decode.
"""

from __future__ import annotations

import torch

from move2kube_tpu_torch.ops._build import FLOAT, INT, PTR, CudaKernel

_NEG_INF = -1e30

FLASH_FWD = CudaKernel(
    "flash_fwd", "m2kt_flash_fwd",
    [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, INT,
     PTR])
PAGED_DECODE = CudaKernel(
    "paged_decode", "m2kt_paged_decode",
    [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, FLOAT, INT,
     INT, PTR])
KERNELS = (FLASH_FWD, PAGED_DECODE)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


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


def reference_attention(q, k, v, causal: bool, scale: float):
    """Plain version of the flash kernel (``_reference_attention`` in the
    JAX package): scores in the input type, softmax in fp32, probabilities
    cast to v's type for the PV product. ``k``/``v`` may carry fewer heads
    than ``q`` (GQA) and are repeated up to it."""
    rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    _kernel_args_ok("flash_attention", {"q": q, "k": k, "v": v}, q.dtype, d)
    out = torch.empty_like(q)
    if s == 0 or b * h == 0:
        return out
    dev, stream = _stream_args(q)
    FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, sk, h, kvh, d, int(causal),
                     float(scale), _DTYPE_CODES[q.dtype], dev, stream)
    return out


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """Fused attention forward. ``q``: ``[b, s, h, d]``; ``k``/``v``:
    ``[b, sk, kvh, d]`` with ``kvh`` dividing ``h`` (query head i reads KV
    head ``i // (h // kvh)``, as repeating K/V up to ``h`` heads would).
    Causal masking compares absolute positions (query i sees keys <= i).
    Any ``s`` and ``sk``: the kernel masks ragged tails itself.

    CUDA tensors launch ``csrc/flash_fwd.cu``; CPU tensors take
    :func:`reference_attention`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or (
            k.shape[3] != q.shape[3]) or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, scale)
    raise ValueError(f"flash_attention: no implementation on {q.device}")


# --------------------------------------------------------------------------
# paged decode attention
# --------------------------------------------------------------------------


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


def _paged_decode_cuda(q, k_pages, v_pages, block_tables, seq_lens,
                       scale: float):
    b, h, d = q.shape
    _, block_size, kvh, _ = k_pages.shape
    _kernel_args_ok("paged_decode_attention",
                    {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                     "block_tables": block_tables, "seq_lens": seq_lens},
                    q.dtype, d)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q and the page pools must "
                        f"share one dtype (q {q.dtype}, pages "
                        f"{k_pages.dtype})")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and seq_lens "
                        "must be int32")
    if block_size % 8:
        raise ValueError("paged_decode_attention: the CUDA kernel needs "
                         f"block_size % 8 == 0 (got {block_size})")
    if h // kvh not in (1, 2, 4, 8):
        raise ValueError("paged_decode_attention: the CUDA kernel serves "
                         f"1, 2, 4 or 8 query heads per KV head (got "
                         f"{h // kvh})")
    out = torch.empty_like(q)
    if b == 0:
        return out
    dev, stream = _stream_args(q)
    PAGED_DECODE.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                        block_tables.data_ptr(), seq_lens.data_ptr(),
                        out.data_ptr(), b, h, kvh, d, block_size,
                        block_tables.shape[1], float(scale),
                        _DTYPE_CODES[q.dtype], dev, stream)
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale: float | None = None):
    """Decode-step attention against a paged KV cache. GQA-aware.

    - ``q``: ``[batch, heads, head_dim]``, one new query token per slot
    - ``k_pages``/``v_pages``: ``[num_pages, block_size, kv_heads,
      head_dim]``
    - ``block_tables``: ``[batch, max_pages_per_seq]`` int32 page indices
      (unused entries point at page 0, which is never read)
    - ``seq_lens``: ``[batch]`` int32 valid-token counts, INCLUDING the
      token being decoded (its K/V is already in the cache)

    CUDA tensors launch ``csrc/paged_decode.cu``; CPU tensors take
    :func:`paged_decode_reference`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.ndim != 3 or k_pages.shape != v_pages.shape or (
            k_pages.shape[3] != q.shape[2]) or q.shape[1] % k_pages.shape[2]:
        raise ValueError(
            f"paged_decode_attention: bad shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)}")
    if q.is_cuda:
        return _paged_decode_cuda(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, block_tables,
                                      seq_lens, scale)
    raise ValueError(
        f"paged_decode_attention: no implementation on {q.device}")
