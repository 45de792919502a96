"""Weights for the port's models: from a flax parameter tree, or drawn on
the device.

:func:`params_from_jax` maps the JAX package's ``Llama`` params (as a
tree of numpy arrays, e.g. from ``jax.device_get``) onto the port's
``state_dict``: flax ``Dense`` kernels ``[in, out]`` become ``nn.Linear``
weights ``[out, in]``, the fused ``qkv``/``gate_up`` projections stay
fused, ``embed/embedding`` becomes the embedding table and the norms'
``scale`` stays a vector; GPT-2's, BERT's, ResNet's and the UNet's trees
map the same way (flax ``Conv`` kernels ``[kh, kw, in, out]`` become
``[out, in, kh, kw]``, ResNet's ``batch_stats`` the BatchNorm buffers).
Matrices take ``cfg.dtype`` (what flax's ``dtype=`` computes in); the
norm scales and the lm-head stay fp32, as flax keeps and computes them.
The JAX package's int8 tree (``serving/quant.quantize_variables``: each
kernel a ``{"q8", "scale"}`` leaf, a bias beside it as it was) maps onto
a quantized model's buffers (``serving/quant.quantize_model``): ``q8``
transposed to ``[out, in]``, ``scale`` to ``[out, 1]``.

:func:`init_llama` builds a model and initialises it where it lives, in
its own types, from a ``torch.Generator`` on that device, with flax's
default distributions: lecun-normal (truncated at two standard
deviations) for ``Dense``, normal with variance 1/d_model for ``Embed``,
ones for the norms; :func:`init_gpt2` does the same for GPT-2 and
:func:`init_family` for BERT, ResNet and the UNet. Drawing the 8B
weights on the host in fp32 would take 32 GB and minutes; on the card it
takes seconds. The draws differ from ``jax.random``'s for the same seed.

The top-level names of both trees are one table, :data:`FLAX_TOP` (the
port's ``layers.3`` is flax's ``layer_3``): :func:`params_from_jax`
reads the flax tree through it, and :func:`flax_group` gives the flax
name of any port parameter, which the tensor-health plane
(:mod:`move2kube_tpu_torch.obs.numerics`) names its layer groups by.

The HuggingFace and torchvision converters (:func:`llama_params_from_torch`,
:func:`gpt2_params_from_torch`, :func:`bert_params_from_torch`,
:func:`resnet_params_from_torch`, with :func:`infer_num_layers`) keep the
JAX package's names and take the same ``state_dict``s (tensors or numpy
arrays), but return the port's ``state_dict`` in fp32, which the port's
model loads with ``load_state_dict(strict=True)``: a torch ``Linear``
weight ``[out, in]`` is already an ``nn.Linear`` weight, q/k/v (k and v
with ``kvh * d`` rows under GQA) and gate/up concatenate along the rows
into the fused ``qkv``/``gate_up``, HF GPT-2's ``Conv1D`` weights
``[in, out]`` are transposed, and torchvision's ``OIHW`` convolutions
stay as they are.

Training keeps fp32 master weights: from the JAX package,
``params_from_jax(p, dataclasses.replace(cfg, dtype=torch.float32))``;
drawn on the card, ``init_llama(cfg, seed, dtype=torch.float32)``. The
training step casts them to its compute dtype inside the loss.
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch

from move2kube_tpu_torch._device import resolve_device
from move2kube_tpu_torch.models.bert import BertConfig, BertEncoder
from move2kube_tpu_torch.models.gpt2 import GPT2, GPT2Config
from move2kube_tpu_torch.models.layers import (
    Conv,
    Dense,
    Embed,
    lecun_normal_,
)
from move2kube_tpu_torch.models.llama import Llama, LlamaConfig
from move2kube_tpu_torch.models.resnet import ResNet, ResNetConfig
from move2kube_tpu_torch.models.unet import UNet, UNetConfig

_LINEARS = ("qkv", "attn_out", "gate_up", "down")
_MOE_EXPERTS = ("w_in", "w_gate", "w_out")
_NORMS = ("attn_norm", "mlp_norm")
_GPT2_LINEARS = ("c_attn", "attn_out", "c_fc", "mlp_out")

# each family's top-level parameter names, the port's -> flax's ("{}"
# takes the index that follows the port's name). The UNet's port names
# are its flax paths, so it has no entries.
FLAX_TOP = {
    LlamaConfig: {"embed": "embed", "layers": "layer_{}",
                  "final_norm": "final_norm", "lm_head": "lm_head"},
    GPT2Config: {"wte": "wte", "wpe": "wpe", "h": "h_{}", "ln_f": "ln_f"},
    BertConfig: {"tok_embed": "tok_embed", "pos_embed": "pos_embed",
                 "seg_embed": "seg_embed", "embed_norm": "LayerNorm_0",
                 "layers": "BertLayer_{}", "pooler": "pooler",
                 "classifier": "classifier"},
    ResNetConfig: {"stem_conv": "Conv_0", "stem_norm": "BatchNorm_0",
                   "blocks": "BottleneckBlock_{}", "head": "Dense_0"},
    UNetConfig: {},
}


def _top(kind, port: str, index: int | None = None) -> str:
    """Flax's top-level name for the port's ``port`` (block ``index``)."""
    name = FLAX_TOP[kind][port]
    return name.format(index) if "{}" in name else name


def flax_group(cfg, name: str) -> str:
    """The flax tree's top-level name of the port's parameter ``name`` in
    a model of config ``cfg`` (``layers.3.qkv.weight`` -> ``layer_3`` for
    Llama, ``h.0.c_fc.bias`` -> ``h_0`` for GPT-2); a name the table does
    not know keeps its first component."""
    table = next((t for kind, t in FLAX_TOP.items()
                  if isinstance(cfg, kind)), {})
    head, _, rest = name.partition(".")
    flax = table.get(head)
    if flax is None:
        return head
    return flax.format(rest.partition(".")[0]) if "{}" in flax else flax


# names below the top level that differ between the trees (the port's
# -> flax's); the other families keep flax's names there
FLAX_INNER = {
    BertConfig: {"attn": "BertSelfAttention_0", "attn_norm": "LayerNorm_0",
                 "mlp_in": "Dense_0", "mlp_out": "Dense_1",
                 "mlp_norm": "LayerNorm_1"},
    ResNetConfig: {"conv1": "Conv_0", "conv2": "Conv_1", "conv3": "Conv_2",
                   "proj_conv": "Conv_3", "norm1": "BatchNorm_0",
                   "norm2": "BatchNorm_1", "norm3": "BatchNorm_2",
                   "proj_norm": "BatchNorm_3"},
}


def flax_params(model) -> dict:
    """Every parameter of ``model`` (a port model, its ``cfg`` attached)
    by its flax path and shape: ``{port name: ("a/b/kernel", flax
    shape)}``. A ``Linear`` weight ``[out, in]`` is flax's ``kernel [in,
    out]``, a ``Conv`` weight ``[out, in, kh, kw]`` its ``kernel [kh, kw,
    in, out]``, an embedding's weight its ``embedding``, a norm's weight
    its ``scale``. The inverse of :func:`params_from_jax`'s map."""
    return {name: (path, shape)
            for name, (path, shape, _) in flax_layout(model).items()}


def flax_layout(model) -> dict:
    """:func:`flax_params` with each leaf's dimension map: ``{port name:
    (flax path, flax shape, order)}``, where flax dimension i is port
    dimension ``order[i]`` (``(1, 0)`` for a ``Linear`` weight, ``(2, 3,
    1, 0)`` for a ``Conv`` weight, the identity otherwise). A model
    without a ``cfg`` keeps its own names as the paths."""
    cfg = getattr(model, "cfg", None)
    inner = next((t for kind, t in FLAX_INNER.items()
                  if isinstance(cfg, kind)), {})
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        *mods, leaf = name.split(".")
        owner = modules[".".join(mods)]
        shape = tuple(p.shape)
        order = tuple(range(len(shape)))
        if leaf == "weight":
            if isinstance(owner, torch.nn.Linear):
                leaf, order = "kernel", (1, 0)
            elif isinstance(owner, torch.nn.Conv2d):
                leaf, order = "kernel", (2, 3, 1, 0)
            elif isinstance(owner, (torch.nn.Embedding, Embed)):
                leaf = "embedding"
            else:
                leaf = "scale"
        shape = tuple(shape[i] for i in order)
        path = []
        if mods:
            top = flax_group(cfg, name)
            path.append(top)
            # an indexed top name ("layer_3") took the index after it
            rest = mods[2:] if top != mods[0] and len(mods) > 1 and \
                mods[1].isdigit() else mods[1:]
            path += [inner.get(m, m) for m in rest]
        out[name] = ("/".join(path + [leaf]), shape, order)
    return out


def meta_model(cfg):
    """The model of ``cfg``'s family on ``torch.device("meta")``, with
    fp32 parameters (the training masters): shapes without memory."""
    models = {LlamaConfig: Llama, GPT2Config: GPT2, BertConfig: BertEncoder,
              ResNetConfig: ResNet, UNetConfig: UNet}
    if isinstance(cfg, (LlamaConfig, GPT2Config)):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return models[type(cfg)](cfg, device="meta")


def _np32(x):
    return np.asarray(x, np.float32)


def _tensor(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _dense_into(sd, prefix, leaf, dtype):
    """A flax ``Dense`` leaf (``kernel [in, out]``, maybe ``bias``) as
    ``nn.Linear`` entries: ``weight [out, in]``, or the int8 tree's
    ``{"q8", "scale"}`` kernel as a :class:`QuantLinear`'s ``q8 [out, in]``
    and ``scale [out, 1]``; the bias takes ``dtype`` too."""
    kernel = leaf["kernel"]
    if isinstance(kernel, dict) and set(kernel) == {"q8", "scale"}:
        for key, t in (("q8", np.int8), ("scale", np.float32)):
            sd[f"{prefix}.{key}"] = torch.from_numpy(
                np.array(np.asarray(kernel[key], t).T, order="C"))
    else:
        sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(
            _np32(kernel).T)).to(dtype)
    if "bias" in leaf:
        sd[f"{prefix}.bias"] = _tensor(leaf["bias"], dtype)


def _norm_into(sd, prefix, leaf):
    sd[f"{prefix}.weight"] = _tensor(leaf["scale"])
    sd[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _conv_into(sd, prefix, leaf):
    """flax ``Conv`` kernel ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``."""
    sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(
        _np32(leaf["kernel"]).transpose(3, 2, 0, 1)))
    if "bias" in leaf:
        sd[f"{prefix}.bias"] = _tensor(leaf["bias"])


def params_from_jax(params: dict, cfg) -> dict:
    """A flax parameter tree (numpy leaves; an outer ``{"params": ...}``
    is accepted too) -> the port's ``state_dict`` (CPU tensors), by the
    config's family: ``LlamaConfig`` (MoE included; plain or int8),
    ``GPT2Config`` (plain or int8), ``BertConfig``, ``ResNetConfig``
    (pass the whole variables, ``{"params", "batch_stats"}``: the
    running statistics become the norms' ``mean``/``var`` buffers) or
    ``UNetConfig``. An int8 tree gives the ``state_dict`` of the
    quantized model."""
    p = params.get("params", params)
    for kind, fn in ((LlamaConfig, _llama_sd), (GPT2Config, _gpt2_sd),
                     (BertConfig, _bert_sd), (UNetConfig, _unet_sd)):
        if isinstance(cfg, kind):
            return fn(p, cfg)
    if isinstance(cfg, ResNetConfig):
        return _resnet_sd(p, params.get("batch_stats"), cfg)
    raise TypeError(f"params_from_jax: no mapping for {type(cfg).__name__}")


def _llama_sd(p, cfg: LlamaConfig) -> dict:
    L = LlamaConfig
    sd = {"embed.weight": _tensor(p[_top(L, "embed")]["embedding"],
                                  cfg.dtype)}
    for i in range(cfg.num_layers):
        layer = p[_top(L, "layers", i)]
        names = _LINEARS[:2] if cfg.moe_experts else _LINEARS
        for name in names:
            _dense_into(sd, f"layers.{i}.{name}", layer[name], cfg.dtype)
        if cfg.moe_experts:
            moe = layer["moe"]
            _dense_into(sd, f"layers.{i}.moe.router", moe["router"],
                        torch.float32)
            for name in _MOE_EXPERTS:
                sd[f"layers.{i}.moe.{name}"] = _tensor(moe[name], cfg.dtype)
        for name in _NORMS:
            sd[f"layers.{i}.{name}.scale"] = _tensor(layer[name]["scale"])
    sd["final_norm.scale"] = _tensor(p[_top(L, "final_norm")]["scale"])
    _dense_into(sd, "lm_head", p[_top(L, "lm_head")], torch.float32)
    return sd


def _gpt2_sd(p, cfg: GPT2Config) -> dict:
    G = GPT2Config
    sd = {f"{name}.weight": _tensor(p[_top(G, name)]["embedding"], cfg.dtype)
          for name in ("wte", "wpe")}
    for i in range(cfg.num_layers):
        block = p[_top(G, "h", i)]
        for name in _GPT2_LINEARS:
            _dense_into(sd, f"h.{i}.{name}", block[name], cfg.dtype)
        for name in ("ln_1", "ln_2"):
            _norm_into(sd, f"h.{i}.{name}", block[name])
    _norm_into(sd, "ln_f", p[_top(G, "ln_f")])
    return sd


def _bert_sd(p, cfg: BertConfig) -> dict:
    B = BertConfig
    sd = {f"{name}.weight": _tensor(p[_top(B, name)]["embedding"])
          for name in ("tok_embed", "pos_embed", "seg_embed")}
    _norm_into(sd, "embed_norm", p[_top(B, "embed_norm")])
    for i in range(cfg.num_layers):
        layer, pre = p[_top(B, "layers", i)], f"layers.{i}"
        attn = layer["BertSelfAttention_0"]
        for name in ("qkv", "out"):
            _dense_into(sd, f"{pre}.attn.{name}", attn[name], torch.float32)
        _norm_into(sd, f"{pre}.attn_norm", layer["LayerNorm_0"])
        _dense_into(sd, f"{pre}.mlp_in", layer["Dense_0"], torch.float32)
        _dense_into(sd, f"{pre}.mlp_out", layer["Dense_1"], torch.float32)
        _norm_into(sd, f"{pre}.mlp_norm", layer["LayerNorm_1"])
    for name in ("pooler", "classifier"):
        _dense_into(sd, name, p[_top(B, name)], torch.float32)
    return sd


def _bn_into(sd, prefix, leaf, stats):
    _norm_into(sd, prefix, leaf)
    if stats is not None:
        sd[f"{prefix}.mean"] = _tensor(stats["mean"])
        sd[f"{prefix}.var"] = _tensor(stats["var"])


def _resnet_sd(p, stats, cfg: ResNetConfig) -> dict:
    R = ResNetConfig
    stats = stats or {}
    sd = {}
    _conv_into(sd, "stem_conv", p[_top(R, "stem_conv")])
    _bn_into(sd, "stem_norm", p[_top(R, "stem_norm")],
             stats.get(_top(R, "stem_norm")))
    for i in range(sum(cfg.stage_sizes)):
        name = _top(R, "blocks", i)
        block, bstats = p[name], stats.get(name, {})
        pairs = [("conv1", "norm1", 0), ("conv2", "norm2", 1),
                 ("conv3", "norm3", 2)]
        if "Conv_3" in block:
            pairs.append(("proj_conv", "proj_norm", 3))
        for conv, norm, j in pairs:
            _conv_into(sd, f"blocks.{i}.{conv}", block[f"Conv_{j}"])
            _bn_into(sd, f"blocks.{i}.{norm}", block[f"BatchNorm_{j}"],
                     bstats.get(f"BatchNorm_{j}"))
    _dense_into(sd, "head", p[_top(R, "head")], torch.float32)
    return sd


def _unet_sd(p, cfg: UNetConfig) -> dict:
    sd = {}

    def walk(prefix, node):
        if "kernel" in node:
            if np.ndim(node["kernel"]) == 4:
                _conv_into(sd, prefix, node)
            else:
                _dense_into(sd, prefix, node, torch.float32)
        elif "scale" in node:
            _norm_into(sd, prefix, node)
        else:
            for key, sub in node.items():
                walk(f"{prefix}.{key}" if prefix else key, sub)

    walk("", p)
    return sd


# -- HuggingFace / torchvision state dicts -> the port's state dict -------

_LAYER_RES = {
    # keys may be bare ('encoder.layer.0...', 'layers.0...') or prefixed
    # ('bert.encoder.layer.0...', 'model.layers.0...'); family 'gpt'
    # (Megatron-style, ported through the llama converter) must not match
    # HF GPT-2's 'h.N' keys
    "bert": re.compile(r"(?:^|\.)encoder\.layer\.(\d+)\."),
    "llama": re.compile(r"(?:^|\.)layers\.(\d+)\."),
    "gpt": re.compile(r"(?:^|\.)layers\.(\d+)\."),
    "gpt2": re.compile(r"(?:^|\.)h\.(\d+)\."),
}


def infer_num_layers(state_dict: dict, family: str) -> int:
    """Count transformer blocks in a torch/HF state_dict by key pattern."""
    pat = _LAYER_RES.get(family)
    if pat is None:
        raise ValueError(f"no layer pattern for model family {family!r}")
    ids = [int(m.group(1)) for k in state_dict if (m := pat.search(k))]
    if not ids:
        raise ValueError(
            f"no {family!r} layer keys found in state_dict "
            f"(looked for {pat.pattern!r})")
    return 1 + max(ids)


def _f32(t) -> torch.Tensor:
    """A checkpoint entry (tensor or array) as a contiguous fp32 CPU
    tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(t, np.float32))


def _cat_rows(sd: dict, names) -> torch.Tensor:
    return torch.cat([_f32(sd[n]) for n in names], dim=0)


def _copy(out: dict, dst: str, sd: dict, src: str, bias: bool = True):
    """A torch ``Linear``/``LayerNorm`` (``weight``, optional ``bias``)
    under the port's name ``dst``."""
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if bias and f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def llama_params_from_torch(state_dict: dict, num_layers: int) -> dict:
    """HF ``LlamaForCausalLM`` (or bare ``LlamaModel``) state_dict -> the
    port's ``Llama`` state dict (fp32)."""
    sd = dict(state_dict)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    out = {"embed.weight": _f32(sd[pre + "embed_tokens.weight"])}
    for i in range(num_layers):
        lp, dp = f"{pre}layers.{i}.", f"layers.{i}."
        out[dp + "qkv.weight"] = _cat_rows(
            sd, [f"{lp}self_attn.{x}_proj.weight" for x in "qkv"])
        out[dp + "attn_out.weight"] = _f32(sd[lp + "self_attn.o_proj.weight"])
        out[dp + "gate_up.weight"] = _cat_rows(
            sd, [f"{lp}mlp.{x}_proj.weight" for x in ("gate", "up")])
        out[dp + "down.weight"] = _f32(sd[lp + "mlp.down_proj.weight"])
        out[dp + "attn_norm.scale"] = _f32(sd[lp + "input_layernorm.weight"])
        out[dp + "mlp_norm.scale"] = _f32(
            sd[lp + "post_attention_layernorm.weight"])
    out["final_norm.scale"] = _f32(sd[pre + "norm.weight"])
    # tied embeddings when the checkpoint has no separate head
    out["lm_head.weight"] = _f32(sd.get("lm_head.weight",
                                        sd[pre + "embed_tokens.weight"]))
    return out


def gpt2_params_from_torch(state_dict: dict, num_layers: int) -> dict:
    """HF ``GPT2LMHeadModel`` (or bare ``GPT2Model``) state_dict -> the
    port's ``GPT2`` state dict (fp32). HF's ``Conv1D`` stores ``[in,
    out]``, so each becomes an ``nn.Linear`` weight by a transpose; the
    head is tied to ``wte`` in both models."""
    sd = dict(state_dict)
    pre = ("transformer."
           if any(k.startswith("transformer.") for k in sd) else "")
    out = {"wte.weight": _f32(sd[pre + "wte.weight"]),
           "wpe.weight": _f32(sd[pre + "wpe.weight"])}
    for i in range(num_layers):
        lp, dp = f"{pre}h.{i}.", f"h.{i}."
        for dst, src in (("c_attn", "attn.c_attn"), ("attn_out", "attn.c_proj"),
                         ("c_fc", "mlp.c_fc"), ("mlp_out", "mlp.c_proj")):
            out[f"{dp}{dst}.weight"] = _f32(
                sd[f"{lp}{src}.weight"]).t().contiguous()
            out[f"{dp}{dst}.bias"] = _f32(sd[f"{lp}{src}.bias"])
        _copy(out, dp + "ln_1", sd, lp + "ln_1")
        _copy(out, dp + "ln_2", sd, lp + "ln_2")
    _copy(out, "ln_f", sd, pre + "ln_f")
    return out


def bert_params_from_torch(state_dict: dict, num_layers: int) -> dict:
    """HF ``BertForSequenceClassification`` (or bare ``BertModel``)
    state_dict -> the port's ``BertEncoder`` state dict (fp32)."""
    sd = dict(state_dict)
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    emb = pre + "embeddings."
    out = {"tok_embed.weight": _f32(sd[emb + "word_embeddings.weight"]),
           "pos_embed.weight": _f32(sd[emb + "position_embeddings.weight"]),
           "seg_embed.weight": _f32(sd[emb + "token_type_embeddings.weight"])}
    _copy(out, "embed_norm", sd, emb + "LayerNorm")
    for i in range(num_layers):
        lp, dp = f"{pre}encoder.layer.{i}.", f"layers.{i}."
        qkv = [f"{lp}attention.self.{x}" for x in ("query", "key", "value")]
        out[dp + "attn.qkv.weight"] = _cat_rows(sd, [n + ".weight"
                                                     for n in qkv])
        out[dp + "attn.qkv.bias"] = _cat_rows(sd, [n + ".bias" for n in qkv])
        _copy(out, dp + "attn.out", sd, lp + "attention.output.dense")
        _copy(out, dp + "attn_norm", sd, lp + "attention.output.LayerNorm")
        _copy(out, dp + "mlp_in", sd, lp + "intermediate.dense")
        _copy(out, dp + "mlp_out", sd, lp + "output.dense")
        _copy(out, dp + "mlp_norm", sd, lp + "output.LayerNorm")
    if pre + "pooler.dense.weight" in sd:
        _copy(out, "pooler", sd, pre + "pooler.dense")
    if "classifier.weight" in sd:
        _copy(out, "classifier", sd, "classifier")
    return out


def resnet_params_from_torch(state_dict: dict) -> tuple[dict, dict]:
    """torchvision ``resnet50`` state_dict -> ``(params, batch_stats)`` of
    the port's ``ResNet``: the parameters, and the BatchNorms' running
    ``mean``/``var`` buffers; together they are its state dict."""
    sd = {k: v for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    params: dict = {}
    stats: dict = {}

    def bn(dst: str, src: str) -> None:
        _copy(params, dst, sd, src)
        stats[f"{dst}.mean"] = _f32(sd[src + ".running_mean"])
        stats[f"{dst}.var"] = _f32(sd[src + ".running_var"])

    params["stem_conv.weight"] = _f32(sd["conv1.weight"])
    bn("stem_norm", "bn1")
    block = 0
    for stage, units in enumerate((3, 4, 6, 3), start=1):  # resnet50
        for unit in range(units):
            tp, dp = f"layer{stage}.{unit}", f"blocks.{block}"
            for j in (1, 2, 3):
                params[f"{dp}.conv{j}.weight"] = _f32(sd[f"{tp}.conv{j}.weight"])
                bn(f"{dp}.norm{j}", f"{tp}.bn{j}")
            if f"{tp}.downsample.0.weight" in sd:
                params[f"{dp}.proj_conv.weight"] = _f32(
                    sd[f"{tp}.downsample.0.weight"])
                bn(f"{dp}.proj_norm", f"{tp}.downsample.1")
            block += 1
    if "fc.weight" in sd:
        _copy(params, "head", sd, "fc")
    return params, stats


def _init_linear_like(model, gen) -> None:
    """flax's default draws over a model's layers: lecun-normal kernels
    (a convolution's fan-in counts its window), zero biases, embeddings
    normal with variance 1/features; norms keep ones and zeros."""
    for mod in model.modules():
        if isinstance(mod, (Dense, Conv)):
            lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embed):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight.shape[1]),
                               generator=gen)


@torch.no_grad()
def init_family(cfg, seed: int = 0, device=None):
    """A BERT, ResNet or UNet (by ``cfg``'s type) with fp32 weights drawn
    on ``device`` (the card by default) from ``seed`` with flax's default
    distributions, and fresh BatchNorm statistics."""
    dev = resolve_device(device)
    models = {BertConfig: BertEncoder, ResNetConfig: ResNet,
              UNetConfig: UNet}
    model = models[type(cfg)](cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    _init_linear_like(model, gen)
    return model


@torch.no_grad()
def init_llama(cfg: LlamaConfig, seed: int = 0, device=None,
               dtype: torch.dtype | None = None) -> Llama:
    """A ``Llama`` with random weights drawn on ``device`` (the card by
    default) from ``seed``. ``dtype`` overrides ``cfg.dtype``:
    ``dtype=torch.float32`` gives the fp32 master weights a training step
    updates. One seed gives the same draws whatever ``attn_impl`` is. An
    MoE block's expert weights ``[E, in, out]`` take flax's
    ``lecun_normal`` fan-in over them, ``E * in``."""
    dev = resolve_device(device)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Llama(cfg, device=dev)
    _draw_lm(model, seed, dev, embeds=LM_EMBEDS[LlamaConfig])
    return model


@torch.no_grad()
def init_gpt2(cfg: GPT2Config, seed: int = 0, device=None,
              dtype: torch.dtype | None = None) -> GPT2:
    """A ``GPT2`` with random weights drawn on ``device`` (the card by
    default) from ``seed``, as :func:`init_llama` draws them: lecun-normal
    projections with zero biases, normal embeddings of variance
    1/d_model, LayerNorms of ones and zeros. ``dtype`` overrides
    ``cfg.dtype`` (``torch.float32`` for training's master weights)."""
    dev = resolve_device(device)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = GPT2(cfg, device=dev)
    _draw_lm(model, seed, dev, embeds=LM_EMBEDS[GPT2Config])
    return model


LM_EMBEDS = {LlamaConfig: ("embed.weight",),
             GPT2Config: ("wte.weight", "wpe.weight")}


def _draw_lm(model, seed: int, dev, embeds) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, param in model.named_parameters():
        draw_lm_leaf(model, name, param, gen, embeds)


def draw_lm_leaf(model, name: str, param, gen, embeds) -> None:
    """Fill ``param`` (parameter ``name`` of the LM ``model`` at its
    global shape, or a tensor of that shape) with its draw from ``gen``,
    as :func:`init_llama` and :func:`init_gpt2` draw their leaves in
    ``named_parameters`` order: one leaf at a time, so a sharded state
    can draw each leaf whole and keep its slice."""
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    dev = param.device
    if type(mod).__name__ in ("RMSNorm", "LayerNorm"):
        param.fill_(1.0 if leaf in ("scale", "weight") else 0.0)
    elif leaf == "bias":
        param.zero_()
    elif name in embeds:
        # draw in fp32 (one matrix at a time), then cast into the param
        draw = torch.empty(param.shape, dtype=torch.float32, device=dev)
        draw.normal_(0.0, 1.0 / math.sqrt(model.cfg.d_model), generator=gen)
        param.copy_(draw)
        del draw
    else:
        # nn.Linear weight [out, in]; expert weights [E, in, out]
        fan_in = (param.shape[1] if param.ndim == 2
                  else param.shape[0] * param.shape[1])
        lecun_normal_(param, fan_in, gen)
