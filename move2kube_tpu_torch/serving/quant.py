"""Post-training int8 serving quantization: the port of
``move2kube_tpu/serving/quant.py`` (its draft-model helpers wait for
speculative decoding).

Weight quantization is symmetric per-output-channel int8, applied once
when the engine is built: every ``nn.Linear`` (in ``Llama``: ``qkv``,
``attn_out``, ``gate_up``, ``down`` and ``lm_head``, the modules that are
flax ``Dense`` kernels in the JAX model) becomes a :class:`QuantLinear`
holding an int8 ``q8 [out, in]`` and fp32 ``scale [out, 1]``. The
embedding and the norm scales stay as they are. Each forward dequantizes
its weight as the JAX step does inside its compiled program, ``q8 *
scale`` in fp32, then multiplies in the layer's compute type (fp32 for
the lm-head, as flax's ``Dense(dtype=float32)``). So the resident weights
are the int8 tensors, and the dequantized weight is a transient of one
layer.

The KV half lives in :mod:`.kvcache` (``cache_dtype=torch.int8`` and its
row-scale pools); :func:`~move2kube_tpu_torch.ops.attention.quantize_kv_rows`
is the row quantizer. Policies:

- ``off``     fp32/bf16 weights, compute-dtype KV cache
- ``int8``    int8 weights, compute-dtype KV cache
- ``int8-kv`` int8 weights and an int8 paged KV cache
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

QUANT_OPTIONS = ("off", "int8", "int8-kv")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    name: str = "off"
    quantize_weights: bool = False
    quantize_kv: bool = False

    @property
    def cache_dtype(self) -> torch.dtype | None:
        """Storage dtype of the paged KV cache under this policy (None:
        the model's compute dtype)."""
        return torch.int8 if self.quantize_kv else None


_POLICIES = {
    "off": QuantPolicy(),
    "int8": QuantPolicy(name="int8", quantize_weights=True),
    "int8-kv": QuantPolicy(name="int8-kv", quantize_weights=True,
                           quantize_kv=True),
}


def policy(name: str) -> QuantPolicy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown serving quant policy {name!r}; options: "
            f"{', '.join(QUANT_OPTIONS)}") from None


def from_env(default: str = "off", env=None) -> QuantPolicy:
    """``M2KT_SERVE_QUANT`` names the policy; unknown names fall back to
    ``default`` rather than killing a serving pod over an env typo."""
    env = os.environ if env is None else env
    name = env.get("M2KT_SERVE_QUANT", "") or default
    try:
        return policy(name)
    except ValueError:
        return policy(default)


def quantize_array(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of one ``nn.Linear`` weight
    ``[out, in]``: ``(q8 [out, in] int8, scale [out, 1] fp32)``. The JAX
    package's ``quantize_array`` on the flax kernel ``[in, out]``,
    transposed (its amax over axis 0 is this one over axis 1), with the
    same operations, so the two give the same bits."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q8, scale


class QuantLinear(nn.Module):
    """A bias-free linear layer on an int8 weight with per-output-channel
    fp32 scales. ``compute_dtype`` is the type the product runs in (the
    replaced layer's weight type)."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor,
                 compute_dtype: torch.dtype) -> None:
        super().__init__()
        if q8.dtype != torch.int8 or q8.ndim != 2 or (
                scale.shape != (q8.shape[0], 1)):
            raise ValueError(f"QuantLinear: q8 {q8.dtype} "
                             f"{tuple(q8.shape)}, scale "
                             f"{tuple(scale.shape)}")
        self.register_buffer("q8", q8)
        self.register_buffer("scale", scale.float())
        self.compute_dtype = compute_dtype

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantLinear":
        if lin.bias is not None:
            raise ValueError("QuantLinear: layers with a bias are not "
                             "quantized")
        with torch.no_grad():
            q8, scale = quantize_array(lin.weight)
        return cls(q8, scale, lin.weight.dtype)

    def dequantized(self) -> torch.Tensor:
        """The weight ``[out, in]``: ``q8 * scale`` in fp32, then the
        compute type (the JAX ``dequantize_variables`` leaf, which flax's
        ``Dense`` then casts to its ``dtype``)."""
        return (self.q8.float() * self.scale).to(self.compute_dtype)

    def forward(self, x):
        return F.linear(x, self.dequantized())


def quantize_model(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose every ``nn.Linear`` is a
    :class:`QuantLinear`. The caller's model is left untouched; the copy
    shares its remaining parameters and buffers (the embedding, the norm
    scales) rather than duplicating them, so once the caller drops its
    model only the int8 weights and those stay resident. Layers that are
    already quantized stay as they are."""
    memo = {id(t): t for t in (*model.parameters(), *model.buffers())}
    qmodel = copy.deepcopy(model, memo)
    for parent in list(qmodel.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear):
                setattr(parent, name, QuantLinear.from_linear(child))
    return qmodel


def param_bytes(model: nn.Module) -> int:
    """Bytes of a (possibly quantized) model's parameters and buffers,
    each tensor counted once: what it holds resident on its device."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def logit_gate(ref, got, eps: float = 1e-6) -> dict:
    """Logit-error comparison between a reference (fp32) and a quantized
    run over aligned logit rows: max absolute error, max relative error
    (normalised by the reference row's dynamic range), and greedy top-1
    agreement (the JAX package's gate, copied)."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    if ref.shape != got.shape:
        raise ValueError(f"logit shape mismatch: {ref.shape} vs {got.shape}")
    flat_ref = ref.reshape(-1, ref.shape[-1])
    flat_got = got.reshape(-1, got.shape[-1])
    span = np.maximum(
        flat_ref.max(axis=-1) - flat_ref.min(axis=-1), eps)
    abs_err = np.abs(flat_ref - flat_got).max(axis=-1)
    agree = (flat_ref.argmax(axis=-1) == flat_got.argmax(axis=-1))
    return {
        "rows": int(flat_ref.shape[0]),
        "max_abs_err": float(abs_err.max() if abs_err.size else 0.0),
        "max_rel_err": float((abs_err / span).max() if abs_err.size
                             else 0.0),
        "top1_agreement": float(agree.mean() if agree.size else 1.0),
    }
