"""Mixture-of-Experts MLP: the port of ``move2kube_tpu/models/moe.py``.

Top-k gating as there (Switch/GShard): softmax router probabilities in
fp32, each token sent to its ``top_k`` experts with the chosen
probabilities renormalised, a queue position in each expert from a
cumulative count in token order, and per-expert capacity ``max(top_k,
ceil(T * capacity_factor * top_k / E))`` for the call's ``T`` tokens.
Tokens past an expert's capacity are dropped from it (the block's
residual passes them through), and the GShard load-balancing loss is
returned for the trainer to add.

Dispatch and combine are one-hot products in the compute type, as the
reference computes them: on one card there is no expert axis to
exchange tokens over, so they are plain ``torch.einsum`` products. The
routing depends on the whole call's tokens (the count ``T`` and the
cumulative order), so a decode pass's idle rows take part in it, as they
do in the JAX engine.

The expert weights are ``[E, d, m]`` / ``[E, m, d]`` parameters named as
flax names them (``w_in``, ``w_gate``, ``w_out``) and held in the
model's type; the router is an fp32 ``nn.Linear`` named ``router``, run
in fp32 on the fp32 input (flax's ``Dense(dtype=float32)``). Under
``quantize_model`` the router becomes an int8 layer and the experts
stay as they are, as the JAX package's ``quantize_variables`` leaves
them (they are not ``kernel`` leaves).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from move2kube_tpu_torch.serving.quant import QuantLinear


def top_k_routing(router_logits, num_experts: int, top_k: int,
                  capacity: int):
    """``router_logits [T, E]`` -> ``(dispatch [T, E, C], combine [T, E,
    C], aux)``, dispatch and combine fp32, aux an fp32 scalar."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    topk_p, topk_idx = torch.topk(probs, top_k, dim=-1)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    gates = torch.zeros_like(probs)
    for j in range(top_k):
        gates = gates + (F.one_hot(topk_idx[:, j], num_experts).float()
                         * topk_p[:, j:j + 1])
    mask = gates > 0
    position = torch.cumsum(mask.int(), dim=0) - 1
    keep = mask & (position < capacity)
    slot = torch.where(keep, position, torch.full_like(position, capacity))
    dispatch = F.one_hot(slot.long(), capacity + 1).float()[..., :capacity]
    combine = dispatch * gates[..., None]
    frac_tokens = mask.float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = num_experts * torch.sum(frac_tokens * frac_probs)
    return dispatch, combine, aux


def capacity_for(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    return max(top_k, math.ceil(tokens * capacity_factor * top_k
                                / num_experts))


class MoEMlp(nn.Module):
    """``x [b, s, d] -> (y [b, s, d], aux)``. The expert products run in
    the experts' weight type (the model's compute type, or the training
    step's cast view of the masters)."""

    def __init__(self, d_model: int, num_experts: int, mlp_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(d_model, num_experts, bias=False,
                                dtype=torch.float32)
        e, d, m = num_experts, d_model, mlp_dim
        self.w_in = nn.Parameter(torch.empty(e, d, m, dtype=dtype))
        self.w_gate = nn.Parameter(torch.empty(e, d, m, dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(e, m, d, dtype=dtype))

    def router_logits(self, xt):
        """fp32 router logits ``[T, E]`` of the flattened tokens."""
        r = self.router
        w = r.dequantized() if isinstance(r, QuantLinear) else r.weight
        return F.linear(xt.float(), w.float())

    def forward(self, x):
        b, s, d = x.shape
        tokens = b * s
        capacity = capacity_for(tokens, self.num_experts, self.top_k,
                                self.capacity_factor)
        xt = x.reshape(tokens, d)
        dispatch, combine, aux = top_k_routing(
            self.router_logits(xt), self.num_experts, self.top_k, capacity)
        dt = self.w_in.dtype
        xe = torch.einsum("tec,td->ecd", dispatch.to(dt), xt.to(dt))
        h = torch.bmm(xe, self.w_in)
        g = torch.bmm(xe, self.w_gate)
        ye = torch.bmm(F.silu(g) * h, self.w_out)
        yt = torch.einsum("tec,ecd->td", combine.to(dt), ye)
        return yt.reshape(b, s, d).to(x.dtype), aux
