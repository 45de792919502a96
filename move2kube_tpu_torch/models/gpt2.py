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

Attention is always :func:`move2kube_tpu_torch.ops.attention.
flash_attention` (causal): the JAX model has no einsum path, and
``flash`` is its only single-device ``attn_impl``. Decode against the
paged cache goes through ``paged_decode_attention`` (GPT-2 is MHA, so
the kernels' GQA group is 1), an int8 cache included. Positions index a
learned table of ``n_positions`` rows, so no position may reach it: the
serving engine refuses a ``max_seq`` past it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.layers import LayerNorm
from move2kube_tpu_torch.models.llama import _lora_delta, paged_attention_step
from move2kube_tpu_torch.ops.attention import flash_attention
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
    attn_impl: str = "flash"  # flash (ring/ulysses: not ported)

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
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 9, multi-GPU)")
    if cfg.attn_impl != "flash":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


class GPT2Block(nn.Module):
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
        qkv = self.c_attn(self.ln_1(x).to(x.dtype))
        q, k, v = (t.reshape(b, s, cfg.num_heads, hd).contiguous()
                   for t in qkv.split(d, dim=-1))
        if cache is not None:
            o = paged_attention_step(q, k, v, positions, cache)
        else:
            o = flash_attention(q, k, v, causal=True)
        x = x + self.attn_out(o.reshape(b, s, d))
        h = self.c_fc(self.ln_2(x).to(x.dtype))
        h = self.mlp_out(F.gelu(h, approximate="tanh"))
        return x + h, (k, v)


class GPT2(nn.Module):
    """The decoder. Parameters are created uninitialised on ``device``
    (the card by default): weights come from
    :func:`~move2kube_tpu_torch.models.convert.init_gpt2` or from
    ``load_state_dict``."""

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
            positions = torch.arange(s, device=input_ids.device)[None, :]
        x = self.wte(input_ids) + self.wpe(positions)
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
