"""Weights for the torch ``Llama``: from a flax parameter tree, or drawn on
the device.

:func:`params_from_jax` maps the JAX package's ``Llama`` params (as a
tree of numpy arrays, e.g. from ``jax.device_get``) onto the port's
``state_dict``: flax ``Dense`` kernels ``[in, out]`` become ``nn.Linear``
weights ``[out, in]``, the fused ``qkv``/``gate_up`` projections stay
fused, ``embed/embedding`` becomes the embedding table and the norms'
``scale`` stays a vector. Matrices take ``cfg.dtype`` (what flax's
``dtype=`` computes in); the norm scales and the lm-head stay fp32, as
flax keeps and computes them. The JAX package's int8 tree
(``serving/quant.quantize_variables``: each kernel a ``{"q8", "scale"}``
leaf) maps onto a quantized model's buffers (``serving/quant.
quantize_model``): ``q8`` transposed to ``[out, in]``, ``scale`` to
``[out, 1]``.

:func:`init_llama` builds a model and initialises it where it lives, in
its own types, from a ``torch.Generator`` on that device, with flax's
default distributions: lecun-normal (truncated at two standard
deviations) for ``Dense``, normal with variance 1/d_model for ``Embed``,
ones for the norms. Drawing the 8B weights on the host in fp32 would
take 32 GB and minutes; on the card it takes seconds. The draws differ
from ``jax.random``'s for the same seed.

Training keeps fp32 master weights: from the JAX package,
``params_from_jax(p, dataclasses.replace(cfg, dtype=torch.float32))``;
drawn on the card, ``init_llama(cfg, seed, dtype=torch.float32)``. The
training step casts them to its compute dtype inside the loss.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.llama import Llama, LlamaConfig

_LINEARS = ("qkv", "attn_out", "gate_up", "down")
_NORMS = ("attn_norm", "mlp_norm")
# flax's lecun_normal: a unit normal truncated to [-2, 2] has this std
_TRUNC_STD = 0.87962566103423978


def params_from_jax(params: dict, cfg: LlamaConfig) -> dict:
    """flax ``Llama`` params (numpy leaves; an outer ``{"params": ...}``
    is accepted too), plain or int8 -> the torch ``Llama`` ``state_dict``
    (CPU tensors); an int8 tree gives the ``state_dict`` of the quantized
    model."""
    p = params.get("params", params)

    def mat(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32).T)).to(dtype)

    def linear(prefix, kernel, dtype):
        if isinstance(kernel, dict) and set(kernel) == {"q8", "scale"}:
            for key, t in (("q8", np.int8), ("scale", np.float32)):
                sd[f"{prefix}.{key}"] = torch.from_numpy(
                    np.array(np.asarray(kernel[key], t).T, order="C"))
        else:
            sd[f"{prefix}.weight"] = mat(kernel, dtype)

    def vec(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd = {"embed.weight": torch.from_numpy(
        np.array(p["embed"]["embedding"], np.float32)).to(cfg.dtype)}
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        for name in _LINEARS:
            linear(f"layers.{i}.{name}", layer[name]["kernel"], cfg.dtype)
        for name in _NORMS:
            sd[f"layers.{i}.{name}.scale"] = vec(layer[name]["scale"])
    sd["final_norm.scale"] = vec(p["final_norm"]["scale"])
    linear("lm_head", p["lm_head"]["kernel"], torch.float32)
    return sd


@torch.no_grad()
def init_llama(cfg: LlamaConfig, seed: int = 0, device=None,
               dtype: torch.dtype | None = None) -> Llama:
    """A ``Llama`` with random weights drawn on ``device`` (the card by
    default) from ``seed``. ``dtype`` overrides ``cfg.dtype``:
    ``dtype=torch.float32`` gives the fp32 master weights a training step
    updates. One seed gives the same draws whatever ``attn_impl`` is."""
    dev = resolve_device(device)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Llama(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, param in model.named_parameters():
        if name.endswith(".scale"):
            param.fill_(1.0)
            continue
        # draw in fp32 (one matrix at a time), then cast into the param
        draw = torch.empty(param.shape, dtype=torch.float32, device=dev)
        if name == "embed.weight":
            draw.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
        else:
            fan_in = param.shape[1]  # nn.Linear weight is [out, in]
            std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=gen)
        param.copy_(draw)
        del draw
    return model
