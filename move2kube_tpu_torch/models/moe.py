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

On a mesh (``mp``, a :class:`~move2kube_tpu_torch.parallel.sharding.
ModelParallel`, set by the training step):

- Routing over the reference's token set. Where the reference's step
  sees the global batch (its GSPMD step and its sequential scan),
  ``mp.route`` is the batch group (data x fsdp x seq): each rank
  exchanges its per-row, per-expert counts over it in rank order,
  capacity comes from the global token count, a token's queue position
  is its place in the global batch's token order (row by row, each row's
  seq shards in order: the counts of the tokens before it on every rank,
  plus its place in its row's shard), and ``frac_tokens`` and
  ``frac_probs`` are global means (``overlap.sum_over``, whose backward
  sums the gradients back), so the aux loss is the reference's. Each rank
  computes only its own tokens' rows: the expert MLP is row-wise, so its
  slots are numbered from its own first token (``min(T, C)`` of them) and
  no ``[E, C_global, d]`` buffer exists. Where the reference routes per
  device (its ``shard_map`` paths: pure data with accumulation, the
  prefetched fsdp step) ``mp.route`` is None and so is the port's.
- The expert axis. A rank holds ``E/ep`` experts (rank r's ``[r E/ep,
  (r+1) E/ep)``), each with its ``mlp`` columns of the tensor axis, and
  dispatches only to them. The input and the gates enter through
  ``overlap.column_entry`` and the combine's partial sum leaves through
  ``overlap.row_exit``, both over the (tensor, expert) group, so the
  router, computed whole on the replicated tokens, has the same gradient
  on every rank.

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

from move2kube_tpu_torch.parallel import overlap
from move2kube_tpu_torch.parallel.sharding import ModelParallel
from move2kube_tpu_torch.serving.quant import QuantLinear


def _route(router_logits, num_experts: int, top_k: int, capacity: int,
           route=None, rows: int = 1, sp: int = 1):
    """``(dispatch [T, E, S], gates [T, E], aux)``: S = ``capacity`` slots
    for this call's tokens alone; over a ``route`` group (module
    docstring) the tokens of every rank of it count, and S = ``min(T,
    capacity)`` slots numbered from this rank's first token. ``rows``:
    the call's rows (its T tokens are ``[rows, T / rows]``); ``sp``: the
    seq extent of the route group, whose rank g holds batch coordinate
    ``g // sp`` and seq coordinate ``g % sp``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    topk_p, topk_idx = torch.topk(probs, top_k, dim=-1)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    gates = torch.zeros_like(probs)
    for j in range(top_k):
        gates = gates + (F.one_hot(topk_idx[:, j], num_experts).float()
                         * topk_p[:, j:j + 1])
    mask = gates > 0
    position = torch.cumsum(mask.int(), dim=0) - 1
    tokens = probs.shape[0]
    if route is None:
        keep = mask & (position < capacity)
        slots = capacity
        frac_tokens = mask.float().mean(dim=0)
        frac_probs = probs.mean(dim=0)
    else:
        per_row = mask.reshape(rows, -1, num_experts)
        # every rank's per-row counts in rank order, [n, rows, E]: exact
        # in fp32
        every = overlap.ring_all_gather(per_row.float().sum(1)[None],
                                        route, 0)
        total = every.shape[0] * tokens
        # a token's queue position in the global batch's token order:
        # the earlier batch coordinates' tokens, this coordinate's earlier
        # rows (every shard of them), this row's earlier shards, then its
        # place in this row's shard
        bc, j = divmod(torch.distributed.get_rank(route), sp)
        grid = every.long().reshape(-1, sp, rows, num_experts)
        whole_rows = grid[bc].sum(0)
        offset = (grid[:bc].sum((0, 1, 2))[None]
                  + torch.cumsum(whole_rows, 0) - whole_rows
                  + grid[bc, :j].sum(0))
        place = torch.cumsum(per_row.long(), dim=1) - 1
        keep = mask & ((offset[:, None] + place).reshape(tokens, -1)
                       < capacity)
        slots = min(tokens, capacity)
        frac_tokens = every.sum(dim=(0, 1)) / total
        frac_probs = overlap.sum_over(probs.sum(dim=0), route) / total
    slot = torch.where(keep, position, torch.full_like(position, slots))
    dispatch = F.one_hot(slot.long(), slots + 1).float()[..., :slots]
    aux = num_experts * torch.sum(frac_tokens * frac_probs)
    return dispatch, gates, aux


def top_k_routing(router_logits, num_experts: int, top_k: int,
                  capacity: int, route=None):
    """``router_logits [T, E]`` -> ``(dispatch [T, E, C], combine [T, E,
    C], aux)``, dispatch and combine fp32, aux an fp32 scalar; over a
    ``route`` group the slots are this rank's (:func:`_route`)."""
    dispatch, gates, aux = _route(router_logits, num_experts, top_k,
                                  capacity, route)
    return dispatch, dispatch * gates[..., None], aux


def capacity_for(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    return max(top_k, math.ceil(tokens * capacity_factor * top_k
                                / num_experts))


class MoEMlp(nn.Module):
    """``x [b, s, d] -> (y [b, s, d], aux)``. The expert products run in
    the experts' weight type (the model's compute type, or the training
    step's cast view of the masters)."""

    mp = None  # ModelParallel on a mesh (module docstring)

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
        """The layer over the route group's tokens (this call's off a
        mesh), on this rank's experts and ``mlp`` columns (module
        docstring); off a mesh every group is None and every collective
        the identity."""
        mp = self.mp or ModelParallel()
        b, s, d = x.shape
        tokens = b * s
        n = (torch.distributed.get_world_size(mp.route)
             if mp.route is not None else 1)
        capacity = capacity_for(tokens * n, self.num_experts, self.top_k,
                                self.capacity_factor)
        xt = x.reshape(tokens, d)
        dispatch, gates, aux = _route(self.router_logits(xt),
                                      self.num_experts, self.top_k, capacity,
                                      mp.route, b, mp.sp)
        local = self.w_in.shape[0]
        lo = mp.ep_rank * local
        gates = overlap.column_entry(gates, mp.te)[:, lo:lo + local]
        dispatch = dispatch[:, lo:lo + local]
        combine = dispatch * gates[..., None]
        xt = overlap.column_entry(xt, mp.te)
        dt = self.w_in.dtype
        xe = torch.einsum("tec,td->ecd", dispatch.to(dt), xt.to(dt))
        h = torch.bmm(xe, self.w_in)
        g = torch.bmm(xe, self.w_gate)
        ye = torch.bmm(F.silu(g) * h, self.w_out)
        yt = torch.einsum("tec,ecd->td", combine.to(dt), ye)
        yt = overlap.row_exit(yt, mp.te)
        return yt.reshape(b, s, d).to(x.dtype), aux
