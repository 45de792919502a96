"""Llama-class decoder-only LM in PyTorch: the port of
``move2kube_tpu/models/llama.py``.

Numerics follow the JAX model: RMSNorm and RoPE (split halves) in fp32,
the projections and MLP in the weights' type, softmax in fp32, and the
lm-head in fp32 on the fp32 hidden state. The forward computes in the
types of the parameters it is run with, so a training step can run it
(``torch.func.functional_call``) on the bf16 view of fp32 master weights
that ``PrecisionPolicy.cast_params`` makes, norm scales and lm-head
included, as the JAX step does. Fused ``qkv`` and ``gate_up``
projections and GQA as there; the parameter names are the flax module
names, so :func:`move2kube_tpu_torch.models.convert.params_from_jax`
maps one tree onto the other.

Attention is selected by ``LlamaConfig.attn_impl``:

- ``dense``: plain einsum attention with the additive -1e30 causal mask
- ``flash``: :func:`move2kube_tpu_torch.ops.attention.flash_attention`
  (the CUDA kernel on the card)

Decode against the paged cache always goes through
:func:`move2kube_tpu_torch.ops.attention.paged_decode_attention`; an int8
cache (one that carries ``k_scale``/``v_scale``) gets each new token's
rows quantized, and its scales passed on. The projections may be the
int8 layers of :func:`move2kube_tpu_torch.serving.quant.quantize_model`.
The multi-LoRA logit delta (``lora=``) is added to the fp32 logits in
every mode, as the JAX model adds it. With ``moe_experts > 0`` each
block's MLP is :class:`~move2kube_tpu_torch.models.moe.MoEMlp` (named
``moe``, as in the JAX model); its load-balancing loss reaches the
train step through ``Llama.moe_aux`` (see :meth:`Llama.forward`). Ring
and ulysses attention are not ported yet (ROADMAP.md, Queue 1 item 9)
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.moe import MoEMlp
from move2kube_tpu_torch.ops.attention import (
    flash_attention,
    paged_decode_attention,
    quantize_kv_rows,
)
from move2kube_tpu_torch.serving.kvcache import PAGE_KEYS
from move2kube_tpu_torch.serving.quant import QuantLinear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    mlp_dim: int = 14336
    max_len: int = 4096
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "dense"  # dense | flash
    moe_experts: int = 0      # 0 = dense MLP; >0 = MoE (models/moe.py)
    moe_top_k: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def llama_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny() -> LlamaConfig:
    """Small variant for tests."""
    return LlamaConfig(vocab_size=512, d_model=128, num_layers=2, num_heads=4,
                       num_kv_heads=2, mlp_dim=256, max_len=256)


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 9, multi-GPU)")
    if cfg.attn_impl not in ("dense", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _rope(x, positions, theta: float):
    """Rotary embeddings in float32, split halves ([b, s, h, d])."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs  # [b, s, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                 + self.eps)
        return (norm * self.scale).to(x.dtype)


def _lora_delta(x32, lora):
    """Per-row LoRA logit delta for the lm-head (the JAX model's
    ``_lora_delta``): gather each batch row's A/B from the stacked
    adapter store and apply ``x32·A·B``. ``x32`` is the fp32 pre-head
    hidden ``[b, s, d]``, ``lora`` is ``(a_stack [rows, d, r], b_stack
    [rows, r, vocab], rows [b])``; returns ``[b, s, vocab]``. Row 0 is
    the all-zeros base-model adapter."""
    a_stack, b_stack, rows = lora
    av = a_stack[rows]   # [b, d, r]
    bv = b_stack[rows]   # [b, r, vocab]
    u = torch.einsum("bsd,bdr->bsr", x32, av)
    return torch.einsum("bsr,brv->bsv", u, bv)


def paged_attention_step(q, k, v, pos, cache):
    """Single-token decode against the paged cache: write this token's
    K/V (``k``/``v`` ``[b, 1, kv_heads, d]``, at positions ``pos [b]``)
    into its page in place, quantized with its row scales when the cache
    is int8, then attend ``q [b, 1, heads, d]`` over the pages named by
    the block table. Returns ``[b, heads, d]``."""
    k_pages, v_pages = cache["k"], cache["v"]
    k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
    block_size = k_pages.shape[1]
    pos = pos.long()
    slot = torch.arange(q.shape[0], device=q.device)
    blk = cache["block_tables"][slot, pos // block_size].long()
    off = pos % block_size
    if k_scale is not None:
        # int8 cache: this token's quantized rows and their
        # per-(token, kv-head) scales
        k_pages[blk, off], k_scale[blk, off] = quantize_kv_rows(k[:, 0])
        v_pages[blk, off], v_scale[blk, off] = quantize_kv_rows(v[:, 0])
    else:
        k_pages[blk, off] = k[:, 0].to(k_pages.dtype)
        v_pages[blk, off] = v[:, 0].to(v_pages.dtype)
    return paged_decode_attention(
        q[:, 0].contiguous(), k_pages, v_pages, cache["block_tables"],
        cache["seq_lens"], k_scale=k_scale, v_scale=v_scale)


def _dense_attention(q, k, v, mask):
    """q/k/v [b, s, h, d] (k/v already repeated to h heads)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s * (q.shape[-1] ** -0.5) + mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_size = cfg.num_heads * hd
        self.kv_size = cfg.num_kv_heads * hd
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.qkv = nn.Linear(cfg.d_model, self.q_size + 2 * self.kv_size,
                             bias=False, dtype=cfg.dtype)
        self.attn_out = nn.Linear(self.q_size, cfg.d_model, bias=False,
                                  dtype=cfg.dtype)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        if cfg.moe_experts > 0:
            self.moe = MoEMlp(cfg.d_model, cfg.moe_experts, cfg.mlp_dim,
                              top_k=cfg.moe_top_k, dtype=cfg.dtype)
        else:
            self.gate_up = nn.Linear(cfg.d_model, 2 * cfg.mlp_dim,
                                     bias=False, dtype=cfg.dtype)
            self.down = nn.Linear(cfg.mlp_dim, cfg.d_model, bias=False,
                                  dtype=cfg.dtype)

    def forward(self, x, positions, mask, cache=None):
        """Returns ``(x, (k, v), aux)``: the rotary-embedded K/V of this
        call (``[b, s, kv_heads, head_dim]``, before any GQA repeat) and
        the MoE load-balancing loss (None for a dense MLP)."""
        cfg = self.cfg
        hd = cfg.head_dim
        h = self.attn_norm(x)
        q, k, v = self.qkv(h).split(
            [self.q_size, self.kv_size, self.kv_size], dim=-1)
        b, s, _ = q.shape
        q = _rope(q.reshape(b, s, cfg.num_heads, hd), positions,
                  cfg.rope_theta)
        k = _rope(k.reshape(b, s, cfg.num_kv_heads, hd), positions,
                  cfg.rope_theta)
        v = v.reshape(b, s, cfg.num_kv_heads, hd)
        if cache is not None:
            o = paged_attention_step(q, k, v, positions[:, 0], cache)
            o = o.reshape(b, 1, self.q_size)
        elif cfg.attn_impl == "flash":
            o = flash_attention(q, k, v.contiguous(), causal=True)
            o = o.reshape(b, s, self.q_size)
        else:
            rep = cfg.num_heads // cfg.num_kv_heads
            o = _dense_attention(q, k.repeat_interleave(rep, dim=2),
                                 v.repeat_interleave(rep, dim=2), mask)
            o = o.reshape(b, s, self.q_size)
        x = x + self.attn_out(o)
        h = self.mlp_norm(x)
        if cfg.moe_experts > 0:
            y, aux = self.moe(h)
            return x + y, (k, v), aux
        gate, up = self.gate_up(h).chunk(2, dim=-1)
        x = x + self.down(F.silu(gate) * up)
        return x, (k, v), None


class Llama(nn.Module):
    """The decoder. Parameters are created uninitialised on ``device``
    (the card by default): weights come from
    :func:`~move2kube_tpu_torch.models.convert.init_llama` or from
    ``load_state_dict``."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      dtype=cfg.dtype)
            self.layers = nn.ModuleList(
                LlamaBlock(cfg) for _ in range(cfg.num_layers))
            self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size,
                                     bias=False, dtype=torch.float32)
        self.to_empty(device=dev)
        # the MoE load-balancing loss of the last full forward (its
        # blocks' summed aux; None for a dense MLP), for the train step
        # to read and clear: the counterpart of flax's ``sow`` into the
        # ``losses`` collection
        self.moe_aux = None

    def forward(self, input_ids, positions=None, cache=None,
                return_kv=False, return_hidden=False, remat=False,
                lora=None):
        """Three modes, one parameter set:

        - full forward (default): ``input_ids [b, s] -> logits [b, s,
          vocab]`` (fp32). With ``return_hidden`` it returns the pre-head
          hidden states after ``final_norm`` instead (``[b, s, d_model]``),
          for the head-folded loss. ``remat`` recomputes each block's
          activations in the backward (``torch.utils.checkpoint``, non-
          reentrant) instead of keeping them.
        - prefill (``return_kv=True``): also returns the per-layer rotary-
          embedded K/V ``[(k, v), ...]`` (``[b, s, kv_heads, head_dim]``)
          for the serving layer to scatter into its paged cache
        - decode (``cache=``): ``input_ids`` is ``[b]``, ONE new token per
          slot at ``positions [b]``; ``cache`` holds per-layer page lists
          ``k``/``v`` (and ``k_scale``/``v_scale`` for an int8 cache),
          ``block_tables`` and ``seq_lens`` (including the new token). The
          pages are written in place. Returns ``(logits [b,
          vocab], cache)``.

        ``lora`` is the multi-LoRA operand ``(a_stack, b_stack, rows)``
        (:mod:`move2kube_tpu_torch.serving.sched.lora`): each batch row's
        adapter delta is added to its fp32 logits, in every mode.

        A full forward of an MoE model (``moe_experts > 0``) leaves the sum
        of its blocks' load-balancing losses in ``self.moe_aux``.
        """
        if cache is not None:
            x = self.embed(input_ids[:, None])
            pos2d = positions[:, None]
            for i, layer in enumerate(self.layers):
                layer_cache = {key: cache[key][i] for key in PAGE_KEYS
                               if key in cache}
                layer_cache["block_tables"] = cache["block_tables"]
                layer_cache["seq_lens"] = cache["seq_lens"]
                x = layer(x, pos2d, None, cache=layer_cache)[0]
            x = self.final_norm(x)
            return self._head(x, lora)[:, 0], cache
        if remat and return_kv:
            raise ValueError("remat recomputes the blocks in the backward; "
                             "it does not return their K/V")
        b, s = input_ids.shape
        x = self.embed(input_ids)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        mask = None
        if self.cfg.attn_impl == "dense":
            idx = torch.arange(s, device=x.device)
            mask = torch.where(idx[:, None] >= idx[None, :], 0.0,
                               -1e30)[None, None].float()
        kvs, aux = [], []
        for layer in self.layers:
            if remat:
                x, layer_aux = _remat_block(layer, x, positions, mask)
            else:
                x, kv, layer_aux = layer(x, positions, mask)
                if return_kv:
                    kvs.append(kv)
            if layer_aux is not None:
                aux.append(layer_aux)
        if aux and not return_kv:
            self.moe_aux = torch.stack(aux).sum()
        x = self.final_norm(x)
        if return_hidden:
            return x
        logits = self._head(x, lora)
        if return_kv:
            return logits, kvs
        return logits

    def _head(self, x, lora=None):
        """fp32 lm-head on the fp32 hidden state; a bf16 weight (the cast
        view in training) is widened first, as flax's ``Dense(dtype=
        float32)`` does, and an int8 head is dequantized to fp32. The
        LoRA delta, when given, is added to the fp32 logits."""
        head = self.lm_head
        w = (head.dequantized() if isinstance(head, QuantLinear)
             else head.weight)
        x32 = x.float()
        logits = F.linear(x32, w.float())
        if lora is not None:
            logits = logits + _lora_delta(x32, lora)
        return logits


def _remat_block(layer, x, positions, mask):
    """One block under ``torch.utils.checkpoint``; returns ``(x, aux)``.
    The parameters the block holds now (under ``functional_call``: the
    cast view, which is swapped out again by the time the backward
    recomputes) are captured here and put back for the recompute, so it
    runs on the same tensors."""
    params = dict(layer.named_parameters())

    def run(x_):
        out = torch.func.functional_call(layer, params,
                                         (x_, positions, mask))
        return out[0], out[2]

    return checkpoint(run, x, use_reentrant=False)
