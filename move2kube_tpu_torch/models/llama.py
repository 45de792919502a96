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
- ``ring`` and ``ulysses``: sequence parallelism (below), ``flash`` off a
  seq group

Decode against the paged cache always goes through
:func:`move2kube_tpu_torch.ops.attention.paged_decode_attention`; an int8
cache (one that carries ``k_scale``/``v_scale``) gets each new token's
rows quantized, and its scales passed on. The projections may be the
int8 layers of :func:`move2kube_tpu_torch.serving.quant.quantize_model`.
The multi-LoRA logit delta (``lora=``) is added to the fp32 logits in
every mode, as the JAX model adds it. With ``moe_experts > 0`` each
block's MLP is :class:`~move2kube_tpu_torch.models.moe.MoEMlp` (named
``moe``, as in the JAX model); its load-balancing loss reaches the
train step through ``Llama.moe_aux`` (see :meth:`Llama.forward`).

Sequence parallelism (a training step on a mesh with a seq axis sets
``mp.sp > 1``): each rank of the seq group holds ``S`` consecutive tokens
of the same rows, rank r the positions ``[r S, (r+1) S)``, which RoPE
takes (``forward(positions=None)`` starts at ``r S``). ``ring`` and
``ulysses`` attention then run
:func:`~move2kube_tpu_torch.parallel.ring_attention.ring_attention` and
:func:`~move2kube_tpu_torch.parallel.ulysses.ulysses_attention` over the
group, K/V at their own head count (the kernels read the GQA groups);
off a seq group (one card, ``seq=1``) they are ``flash``, as the JAX
model falls back. ``flash`` on a seq group runs the ring (the same
exact function; the JAX model's flash sees the whole sequence under
GSPMD). ``dense`` gathers the group's K/V (its gradient summed
back by a reduce-scatter) under the global causal mask, what GSPMD runs
for the reference.

Tensor parallelism (a training step on a mesh with a tensor axis sets
``mp``, a :class:`~move2kube_tpu_torch.parallel.sharding.ModelParallel`,
on the model's modules, and the model holds its
:class:`~move2kube_tpu_torch.parallel.sharding.ShardLayout` parts): each
tensor rank runs its heads, Megatron's split. The normed input enters
the split region through ``overlap.column_entry``; the rank's ``qkv``
rows are its query and KV heads, attention runs on them, and the
row-split ``attn_out`` (its columns of those heads) is summed over the
tensor group by ``overlap.row_exit``. ``gate_up`` holds the rank's cut
of the gate half and of the up half. ``down`` is whole by the reference's
rules (no row-split token matches it); it runs row-split on this rank's
columns of the whole weight (no gather of the activation), and the same
``row_exit`` sums it. The embedding, when its vocab divides, is this
rank's rows: a masked lookup summed over the group; the head is then the
vocab-parallel loss's (``ops/crossentropy.py``). The gradient rule: a
leaf the rules keep whole but that a rank uses only a slice of
(``down`` here) has its gradient summed over the tensor group by the
step; a leaf computed whole on replicated inputs (the norms, an MoE
router) already has the same gradient on every rank and is not reduced.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.moe import MoEMlp
from move2kube_tpu_torch.parallel import overlap
from move2kube_tpu_torch.parallel.sharding import (
    RULES,
    with_logical_constraint,
)
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
    attn_impl: str = "dense"  # dense | flash | ring | ulysses
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
    if cfg.attn_impl not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def seq_split(mp) -> bool:
    return mp is not None and mp.sp > 1


def first_position(mp, s: int) -> int:
    """The global position of this rank's first token: ``sp_rank * s`` on
    a seq group, else 0."""
    return mp.sp_rank * s if seq_split(mp) else 0


def causal_attention(q, k, v, impl: str, mp):
    """Causal attention of this call's tokens for ``attn_impl`` ``flash``,
    ``ring`` or ``ulysses`` (the JAX model's dispatch): over ``mp``'s seq
    group Ulysses attention, or ring attention for ``ring`` and ``flash``
    (the reference's flash runs under GSPMD on the whole sequence), else
    flash. ``k``/``v`` at their own head count."""
    if seq_split(mp):
        from move2kube_tpu_torch.parallel.ring_attention import (
            ring_attention,
        )
        from move2kube_tpu_torch.parallel.ulysses import ulysses_attention

        fn = ulysses_attention if impl == "ulysses" else ring_attention
        return fn(q, k, v, mp.seq, causal=True)
    return flash_attention(q, k, v, causal=True)


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


def masked_lookup(ids, weight, mp):
    """This tensor rank's share of the embedding of ``ids`` from its rows
    ``weight`` (``[V/t, d]``, rank r's rows ``[r V/t, (r+1) V/t)``): the
    rows it holds, zeros for the others."""
    rows = weight.shape[0]
    local = ids - mp.t_rank * rows
    hit = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(hit, local, torch.zeros_like(local)), weight)
    return x * hit[..., None].to(x.dtype)


def vocab_parallel_embed(ids, weight, mp):
    """The embedding of ``ids`` from the tensor ranks' rows: each rank's
    :func:`masked_lookup`, summed over the tensor group."""
    return overlap.row_exit(masked_lookup(ids, weight, mp), mp.tensor)


def tensor_split(mp) -> bool:
    return mp is not None and mp.t > 1


class LlamaBlock(nn.Module):
    mp = None  # ModelParallel on a tensor or expert mesh (module docstring)
    # whole leaves a tensor rank uses a slice of: their gradients are
    # summed over the tensor group (the module docstring's rule)
    tensor_partial = ("down.weight",)

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
        mp = self.mp if cache is None else None
        t = mp.t if tensor_split(mp) else 1
        group = mp.tensor if t > 1 else None
        heads, kv_heads = cfg.num_heads // t, cfg.num_kv_heads // t
        q_size, kv_size = heads * hd, kv_heads * hd
        h = overlap.column_entry(self.attn_norm(x), group)
        qkv = self.qkv(h)
        b, s, _ = qkv.shape
        qkv = with_logical_constraint(
            qkv, mp, RULES, ("batch", None, "heads"),
            (b, s, self.q_size + 2 * self.kv_size))
        q, k, v = qkv.split([q_size, kv_size, kv_size], dim=-1)
        q = _rope(q.reshape(b, s, heads, hd), positions, cfg.rope_theta)
        k = _rope(k.reshape(b, s, kv_heads, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, kv_heads, hd)
        if cache is not None:
            o = paged_attention_step(q, k, v, positions[:, 0], cache)
            o = o.reshape(b, 1, q_size)
        elif cfg.attn_impl != "dense":
            o = causal_attention(q, k.contiguous(), v.contiguous(),
                                 cfg.attn_impl, mp)
            o = o.reshape(b, s, q_size)
        else:
            if seq_split(mp):
                # every rank's keys, under the mask of this rank's rows
                k = overlap.gather_seq(k, mp.seq)
                v = overlap.gather_seq(v, mp.seq)
            rep = heads // kv_heads
            o = _dense_attention(q, k.repeat_interleave(rep, dim=2),
                                 v.repeat_interleave(rep, dim=2), mask)
            o = o.reshape(b, s, q_size)
        # row-split output projection: the tensor group's sum
        x = x + overlap.row_exit(self.attn_out(o), group)
        h = self.mlp_norm(x)
        if cfg.moe_experts > 0:
            y, aux = self.moe(h)
            return x + y, (k, v), aux
        gate_up = self.gate_up(overlap.column_entry(h, group))
        gate_up = with_logical_constraint(
            gate_up, mp, RULES, ("batch", None, "mlp"),
            (b, s, 2 * cfg.mlp_dim))
        gate, up = gate_up.chunk(2, dim=-1)
        act = F.silu(gate) * up
        if group is None:
            return x + self.down(act), (k, v), None
        # down is whole: this rank's columns of it, row-split
        cols = cfg.mlp_dim // t
        w = self.down.weight.narrow(1, mp.t_rank * cols, cols)
        return x + overlap.row_exit(F.linear(act, w), group), (k, v), None


class Llama(nn.Module):
    """The decoder. Parameters are created uninitialised on ``device``
    (the card by default): weights come from
    :func:`~move2kube_tpu_torch.models.convert.init_llama` or from
    ``load_state_dict``."""

    mp = None  # ModelParallel on a tensor or expert mesh (module docstring)

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
        w = self.embed.weight
        if tensor_split(self.mp) and w.shape[0] != self.cfg.vocab_size:
            x = vocab_parallel_embed(input_ids, w, self.mp)
        else:
            x = self.embed(input_ids)
        start = first_position(self.mp, s)
        if positions is None:
            positions = torch.arange(start, start + s,
                                     device=x.device)[None, :].expand(b, s)
        mask = None
        if self.cfg.attn_impl == "dense":
            idx = torch.arange(start, start + s, device=x.device)
            keys = torch.arange(
                s * (self.mp.sp if seq_split(self.mp) else 1),
                device=x.device)
            mask = torch.where(idx[:, None] >= keys[None, :], 0.0,
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
