"""BERT encoder in PyTorch: the port of ``move2kube_tpu/models/bert.py``.

A sequence classifier as the JAX model is: token, position and segment
embeddings summed and layer-normed, post-LN encoder layers with a fused
``qkv`` projection and plain einsum attention (the reference runs no
Pallas kernel here, so neither does the port), a tanh pooler on the
first token and a linear classifier. flax's semantics throughout
(:mod:`.layers`): fp32 parameters, the projections and the MLP in the
config's ``dtype``, softmax, LayerNorm (epsilon 1e-6, flax's default),
pooler and classifier in fp32, and ``nn.gelu``'s default, the tanh GELU.

Module names map onto the flax tree (:func:`~move2kube_tpu_torch.models.
convert.params_from_jax`): ``embed_norm`` is the encoder's
``LayerNorm_0``, ``layers.{i}`` is ``BertLayer_{i}`` with ``attn``
(``BertSelfAttention_0``), ``attn_norm``/``mlp_norm`` (``LayerNorm_0``/
``LayerNorm_1``) and ``mlp_in``/``mlp_out`` (``Dense_0``/``Dense_1``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.layers import Dense, Embed, LayerNorm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    mlp_dim: int = 3072
    max_len: int = 512
    num_classes: int = 2  # sequence classification head
    dtype: torch.dtype = torch.bfloat16


def bert_base(num_classes: int = 2, dtype=torch.bfloat16) -> BertConfig:
    return BertConfig(num_classes=num_classes, dtype=dtype)


def bert_tiny(num_classes: int = 2, dtype=torch.bfloat16) -> BertConfig:
    """Small variant for tests."""
    return BertConfig(vocab_size=1024, num_layers=2, num_heads=2, d_model=64,
                      mlp_dim=128, max_len=128, num_classes=num_classes,
                      dtype=dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = Dense(d_model, 3 * d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)

    def forward(self, x, mask=None):
        b, s, d = x.shape
        hd = d // self.num_heads
        q, k, v = (t.reshape(b, s, self.num_heads, hd)
                   for t in self.qkv(x).split(d, dim=-1))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
        if mask is not None:
            scores = torch.where(mask[:, None, None, :], scores,
                                 torch.full_like(scores, -1e30))
        p = torch.softmax(scores, dim=-1).to(self.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d)
        return self.out(o)


class BertLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.attn = BertSelfAttention(d_model, num_heads, dtype)
        self.attn_norm = LayerNorm(d_model)
        self.mlp_in = Dense(d_model, mlp_dim, dtype)
        self.mlp_out = Dense(mlp_dim, d_model, dtype)
        self.mlp_norm = LayerNorm(d_model)

    def forward(self, x, mask=None):
        x = self.attn_norm(x + self.attn(x, mask))
        y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return self.mlp_norm(x + y)


class BertEncoder(nn.Module):
    """``(input_ids [b, s], attention_mask [b, s] or None, token_type_ids
    or None) -> logits [b, num_classes]`` (fp32). Parameters (fp32) are
    made on ``device``, the card by default, by torch's initialisers:
    :func:`~move2kube_tpu_torch.models.convert.init_family` draws flax's,
    or load a ``state_dict``."""

    def __init__(self, cfg: BertConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        with torch.device(resolve_device(device)):
            self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dt)
            self.pos_embed = Embed(cfg.max_len, cfg.d_model, dt)
            # the segment embedding always takes part (HF semantics:
            # absent token_type_ids mean segment 0)
            self.seg_embed = Embed(2, cfg.d_model, dt)
            self.embed_norm = LayerNorm(cfg.d_model)
            self.layers = nn.ModuleList(
                BertLayer(cfg.d_model, cfg.num_heads, cfg.mlp_dim, dt)
                for _ in range(cfg.num_layers))
            self.pooler = Dense(cfg.d_model, cfg.d_model, torch.float32)
            self.classifier = Dense(cfg.d_model, cfg.num_classes,
                                    torch.float32)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        b, s = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.embed_norm(self.tok_embed(input_ids) + self.pos_embed(pos)
                            + self.seg_embed(token_type_ids))
        mask = (torch.ones(b, s, dtype=torch.bool, device=x.device)
                if attention_mask is None else attention_mask.bool())
        for layer in self.layers:
            x = layer(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)
