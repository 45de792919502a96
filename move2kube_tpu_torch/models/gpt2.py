"""GPT-2 decoder in PyTorch: the port of ``move2kube_tpu/models/gpt2.py``.

HF GPT-2's architecture, as the JAX model has it: learned positional
embeddings, pre-LN blocks, a fused ``c_attn`` projection, the tanh GELU
and the LM head tied to the token embedding. Numerics follow the JAX
model: the LayerNorms in fp32 (epsilon ``norm_eps``), the projections
and MLP in the weights' type, the tied head in fp32 on the fp32 hidden
state. As the port's ``Llama`` does, the forward computes in the types
of the parameters it is run with, so a training step can run it on the
bf16 view of fp32 master weights. The parameter names are the flax
module names (``wte``, ``wpe``, ``h.{i}`` for ``h_{i}``, ``ln_1``,
``c_attn``, ``attn_out``, ``ln_2``, ``c_fc``, ``mlp_out``, ``ln_f``), so
:func:`move2kube_tpu_torch.models.convert.params_from_jax` maps one tree
onto the other. Every projection has a bias.

Attention is :func:`move2kube_tpu_torch.ops.attention.flash_attention`
(causal): the JAX model has no einsum path, and ``flash`` is its only
single-device ``attn_impl``. ``ring`` and ``ulysses`` run ring or
Ulysses attention over a seq group and flash off one (``flash`` on a
seq group runs the ring), through the
port's Llama dispatch (``llama.causal_attention``), as the JAX model
shares the Llama dispatcher; on a seq group each rank's ``wpe`` rows are
its tokens' global positions. Decode against the
paged cache goes through ``paged_decode_attention`` (GPT-2 is MHA, so
the kernels' GQA group is 1), an int8 cache included. Positions index a
learned table of ``n_positions`` rows, so no position may reach it: the
serving engine refuses a ``max_seq`` past it.

Tensor parallelism (``mp`` set by a training step on a tensor mesh, as
for the port's ``Llama``): each rank runs its heads. ``c_attn`` holds the
rank's rows of each of its three thirds (its query, key and value
heads) and ``c_fc`` its rows, entered through ``overlap.column_entry``;
the row-split ``attn_out`` and ``mlp_out`` are summed over the tensor
group by ``overlap.row_exit``, and their biases added once, after the
sum. ``wte`` and ``wpe``, each when its rows divide, are masked lookups
summed over the group, and the tied head follows ``wte`` (the
vocab-parallel loss when it is split, the whole head otherwise). The
gradient rule: ``c_attn``'s and ``c_fc``'s biases are whole by the rules
and each rank adds only its slice, so the step sums their gradients over
the tensor group; the LayerNorms and the row-split layers' biases sit on
replicated values and are not reduced.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.layers import LayerNorm
from move2kube_tpu_torch.models.llama import (
    _lora_delta,
    causal_attention,
    first_position,
    masked_lookup,
    paged_attention_step,
    tensor_split,
)
from move2kube_tpu_torch.parallel import overlap
from move2kube_tpu_torch.parallel.sharding import (
    RULES,
    with_logical_constraint,
)
from move2kube_tpu_torch.serving.kvcache import PAGE_KEYS


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "flash"  # flash | ring | ulysses

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def gpt2_small() -> GPT2Config:
    return GPT2Config()


def gpt2_tiny() -> GPT2Config:
    """Small variant for tests."""
    return GPT2Config(vocab_size=256, n_positions=64, d_model=64,
                      num_layers=2, num_heads=4)


def _check_supported(cfg: GPT2Config) -> None:
    if cfg.attn_impl not in ("flash", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _bias_cut(bias, parts: int, t: int, r: int):
    """Rank r of t's slice of each of a whole bias's ``parts`` equal
    parts, in order (the rows its weight holds)."""
    size = bias.shape[0] // parts
    cut = size // t
    return torch.cat([bias.narrow(0, i * size + r * cut, cut)
                      for i in range(parts)])


class GPT2Block(nn.Module):
    mp = None  # ModelParallel on a tensor mesh (module docstring)
    # whole leaves a tensor rank uses a slice of (the module docstring's
    # gradient rule)
    tensor_partial = ("c_attn.bias", "c_fc.bias")

    def __init__(self, cfg: GPT2Config) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln_1 = LayerNorm(d, cfg.norm_eps)
        self.c_attn = nn.Linear(d, 3 * d, dtype=cfg.dtype)
        self.attn_out = nn.Linear(d, d, dtype=cfg.dtype)
        self.ln_2 = LayerNorm(d, cfg.norm_eps)
        self.c_fc = nn.Linear(d, 4 * d, dtype=cfg.dtype)
        self.mlp_out = nn.Linear(4 * d, d, dtype=cfg.dtype)

    def forward(self, x, positions=None, cache=None):
        """Returns ``(x, (k, v))``, K/V ``[b, s, heads, head_dim]``. With
        ``cache`` (one token a row at ``positions [b]``) the token's K/V
        is written into the pages and attention reads them."""
        cfg = self.cfg
        b, s, d = x.shape
        hd = cfg.head_dim
        mp = self.mp if cache is None else None
        if tensor_split(mp):
            return self._split_forward(x, mp)
        qkv = self.c_attn(self.ln_1(x).to(x.dtype))
        q, k, v = (t.reshape(b, s, cfg.num_heads, hd).contiguous()
                   for t in qkv.split(d, dim=-1))
        if cache is not None:
            o = paged_attention_step(q, k, v, positions, cache)
        else:
            o = causal_attention(q, k, v, cfg.attn_impl, mp)
        x = x + self.attn_out(o.reshape(b, s, d))
        h = self.c_fc(self.ln_2(x).to(x.dtype))
        h = self.mlp_out(F.gelu(h, approximate="tanh"))
        return x + h, (k, v)

    def _split_forward(self, x, mp):
        """The block on this tensor rank's heads (module docstring)."""
        cfg = self.cfg
        b, s, d = x.shape
        t, r, group = mp.t, mp.t_rank, mp.tensor
        heads, dl = cfg.num_heads // t, d // t
        h = overlap.column_entry(self.ln_1(x).to(x.dtype), group)
        qkv = F.linear(h, self.c_attn.weight,
                       _bias_cut(self.c_attn.bias, 3, t, r))
        qkv = with_logical_constraint(qkv, mp, RULES,
                                      ("batch", None, "heads"), (b, s, 3 * d))
        q, k, v = (u.reshape(b, s, heads, cfg.head_dim).contiguous()
                   for u in qkv.split(dl, dim=-1))
        o = causal_attention(q, k, v, cfg.attn_impl, mp)
        y = overlap.row_exit(F.linear(o.reshape(b, s, dl),
                                      self.attn_out.weight), group)
        x = x + (y + self.attn_out.bias)
        h = overlap.column_entry(self.ln_2(x).to(x.dtype), group)
        h = F.linear(h, self.c_fc.weight, _bias_cut(self.c_fc.bias, 1, t, r))
        h = with_logical_constraint(h, mp, RULES, ("batch", None, "mlp"),
                                    (b, s, 4 * d))
        y = overlap.row_exit(F.linear(F.gelu(h, approximate="tanh"),
                                      self.mlp_out.weight), group)
        return x + (y + self.mlp_out.bias), (k, v)


class GPT2(nn.Module):
    """The decoder. Parameters are created uninitialised on ``device``
    (the card by default): weights come from
    :func:`~move2kube_tpu_torch.models.convert.init_gpt2` or from
    ``load_state_dict``."""

    mp = None  # ModelParallel on a tensor mesh (module docstring)

    def __init__(self, cfg: GPT2Config, device=None) -> None:
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                    dtype=cfg.dtype)
            self.wpe = nn.Embedding(cfg.n_positions, cfg.d_model,
                                    dtype=cfg.dtype)
            self.h = nn.ModuleList(GPT2Block(cfg)
                                   for _ in range(cfg.num_layers))
            self.ln_f = LayerNorm(cfg.d_model, cfg.norm_eps)
        self.to_empty(device=dev)

    def forward(self, input_ids, positions=None, cache=None,
                return_kv=False, return_hidden=False, remat=False,
                lora=None):
        """The three modes of the port's ``Llama.forward``, with the same
        arguments and returns: the full forward (``return_hidden`` gives
        the fp32 hidden states after ``ln_f``, ``remat`` recomputes each
        block in the backward), prefill (``return_kv``: per-layer ``(k,
        v)``) and paged single-token decode (``cache=``, ``input_ids``
        and ``positions`` ``[b]``, pages written in place). ``lora`` adds
        each row's adapter delta to the tied head's fp32 logits."""
        if cache is not None:
            x = self.wte(input_ids[:, None]) + self.wpe(positions[:, None])
            for i, block in enumerate(self.h):
                layer_cache = {key: cache[key][i] for key in PAGE_KEYS
                               if key in cache}
                layer_cache["block_tables"] = cache["block_tables"]
                layer_cache["seq_lens"] = cache["seq_lens"]
                x = block(x, positions, cache=layer_cache)[0]
            return self._head(self.ln_f(x), lora)[:, 0], cache
        if remat and return_kv:
            raise ValueError("remat recomputes the blocks in the backward; "
                             "it does not return their K/V")
        b, s = input_ids.shape
        if positions is None:
            start = first_position(self.mp, s)
            positions = torch.arange(start, start + s,
                                     device=input_ids.device)[None, :]
        x = self._embed(input_ids, positions)
        kvs = []
        for block in self.h:
            if remat:
                x = _remat_block(block, x)
            else:
                x, kv = block(x)
                if return_kv:
                    kvs.append(kv)
        x = self.ln_f(x)
        if return_hidden:
            return x
        logits = self._head(x, lora)
        if return_kv:
            return logits, kvs
        return logits

    def _embed(self, input_ids, positions):
        """``wte[ids] + wpe[positions]``; on a tensor mesh each table that
        is this rank's rows is a masked lookup, and their sum over the
        group is one all-reduce."""
        mp = self.mp
        if not tensor_split(mp):
            return self.wte(input_ids) + self.wpe(positions)
        whole, split = [], []
        for table, idx, rows in ((self.wte, input_ids, self.cfg.vocab_size),
                                 (self.wpe, positions, self.cfg.n_positions)):
            if table.weight.shape[0] == rows:
                whole.append(table(idx))
            else:
                split.append(masked_lookup(idx, table.weight, mp))
        x = whole[0] + whole[1] if len(whole) == 2 else None
        if split:
            part = overlap.row_exit(sum(split[1:], split[0]), mp.tensor)
            x = part if not whole else whole[0] + part
        return x

    def _head(self, x, lora=None):
        """The tied head in fp32 on the fp32 hidden state (the embedding
        widened first, as the JAX model does); the LoRA delta, when
        given, is added to the fp32 logits."""
        x32 = x.float()
        logits = F.linear(x32, self.wte.weight.float())
        if lora is not None:
            logits = logits + _lora_delta(x32, lora)
        return logits


def _remat_block(block, x):
    """One block under ``torch.utils.checkpoint`` on the parameters it
    holds now (see the port's ``llama._remat_block``)."""
    params = dict(block.named_parameters())

    def run(x_):
        return torch.func.functional_call(block, params, (x_,))[0]

    return checkpoint(run, x, use_reentrant=False)
