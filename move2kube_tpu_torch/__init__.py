"""PyTorch + CUDA port of move2kube_tpu's compute runtime.

Serving: the synchronous paged-KV engine one fleet replica runs, the
model (:mod:`.models.llama`), its weights (:mod:`.models.convert`), the
paged KV cache (:mod:`.serving.kvcache`) and the continuous-batching
engine (:mod:`.serving.engine`) with its prefix cache
(:mod:`.serving.prefixcache`), speculative decoding, chunked prefill,
drain and deadlines, priority preemption and multi-LoRA
(:mod:`.serving.sched`), the live weight swap, the quant-drift audit and
the install of a prefill done elsewhere, its metrics registry, request
tracing and SLO ledger (:mod:`.obs`). The fleet (:mod:`.serving.fleet`):
the router over in-process replicas (:func:`build_fleet`), disaggregated
prefill, the weight plane and the chaos injectors. int8 serving: the
quant policies, int8 weights dequantized inside each step
(:mod:`.serving.quant`) and the int8 paged KV cache with per-row scales.
Model families: Llama (MoE included, :mod:`.models.moe`) and GPT-2
(:mod:`.models.gpt2`) served and trained on the kernels; BERT, ResNet
and the diffusion UNet (:mod:`.models.bert`, :mod:`.models.resnet`,
:mod:`.models.unet`) with their train steps, in plain PyTorch as the JAX
package runs them outside any Pallas kernel.
Training: the single-device LM step (:mod:`.models.train`) with fp32
master weights, the family steps, the precision policies
(:mod:`.models.precision`) and the head-folded chunked cross-entropy
(:mod:`.ops.crossentropy`). Attention
runs in hand-written CUDA kernels (:mod:`.ops.attention`): the flash
forward, its two backward kernels, and paged decode over fp/bf16 and over
int8 pages. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from move2kube_tpu_torch.models.bert import (
    BertConfig,
    BertEncoder,
    bert_base,
    bert_tiny,
)
from move2kube_tpu_torch.models.convert import (
    init_family,
    init_gpt2,
    init_llama,
    params_from_jax,
)
from move2kube_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    gpt2_small,
    gpt2_tiny,
)
from move2kube_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    llama_8b,
    llama_tiny,
)
from move2kube_tpu_torch.models.moe import MoEMlp, top_k_routing
from move2kube_tpu_torch.models.precision import (
    PrecisionPolicy,
    from_env,
    notfinite_streak,
    policy,
    skipped_updates,
)
from move2kube_tpu_torch.models.train import (
    Optimizer,
    TrainState,
    adam,
    adamw,
    default_optimizer,
    grad_norm_from_state,
    instrument_optimizer,
    make_bert_train_step,
    make_classifier_train_step,
    make_diffusion_train_step,
    make_lm_train_step,
)
from move2kube_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    resnet18_ish,
    resnet50,
)
from move2kube_tpu_torch.models.unet import (
    UNet,
    UNetConfig,
    ddpm_alpha_bars,
    unet_small,
    unet_tiny,
)
from move2kube_tpu_torch.obs.metrics import Registry, default_registry
from move2kube_tpu_torch.obs.slo import SLOSpec, SLOTracker
from move2kube_tpu_torch.obs.tracing import SpanRecorder, parse_traceparent
from move2kube_tpu_torch.ops.attention import (
    KERNELS,
    FlashAttention,
    flash_attention,
    paged_decode_attention,
    quantize_kv_rows,
    reset_launch_counts,
)
from move2kube_tpu_torch.ops.crossentropy import (
    fused_cross_entropy,
    fused_linear_cross_entropy,
    pick_chunk,
)
from move2kube_tpu_torch.serving.engine import (
    Completion,
    DeadlineExceeded,
    EngineConfig,
    EngineDraining,
    Request,
    ServingEngine,
)
from move2kube_tpu_torch.serving.fleet.disagg import (
    DisaggPair,
    KVHandoff,
    PrefillReplica,
)
from move2kube_tpu_torch.serving.fleet.router import (
    InProcessReplica,
    Router,
    RouterConfig,
    RouterHTTPServer,
    build_fleet,
)
from move2kube_tpu_torch.serving.fleet.weights import (
    WeightPlane,
    fetch_from_peers,
)
from move2kube_tpu_torch.serving.prefixcache import PrefixCache, PrefixHit
from move2kube_tpu_torch.serving.quant import (
    QUANT_OPTIONS,
    QuantLinear,
    QuantPolicy,
    draft_config,
    draft_model_from,
    logit_gate,
    param_bytes,
    quantize_model,
)
from move2kube_tpu_torch.serving.sched import (
    AdapterStore,
    AdmissionController,
    SchedThrottled,
)

__all__ = [
    "AdapterStore",
    "AdmissionController",
    "BertConfig",
    "BertEncoder",
    "Completion",
    "DeadlineExceeded",
    "DisaggPair",
    "EngineConfig",
    "EngineDraining",
    "FlashAttention",
    "GPT2",
    "GPT2Config",
    "InProcessReplica",
    "KERNELS",
    "KVHandoff",
    "Llama",
    "LlamaConfig",
    "MoEMlp",
    "Optimizer",
    "PrecisionPolicy",
    "PrefillReplica",
    "PrefixCache",
    "PrefixHit",
    "QUANT_OPTIONS",
    "QuantLinear",
    "QuantPolicy",
    "Registry",
    "Request",
    "ResNet",
    "ResNetConfig",
    "Router",
    "RouterConfig",
    "RouterHTTPServer",
    "SLOSpec",
    "SLOTracker",
    "SchedThrottled",
    "ServingEngine",
    "SpanRecorder",
    "TrainState",
    "UNet",
    "UNetConfig",
    "WeightPlane",
    "adam",
    "adamw",
    "bert_base",
    "bert_tiny",
    "build_fleet",
    "ddpm_alpha_bars",
    "default_optimizer",
    "default_registry",
    "draft_config",
    "draft_model_from",
    "fetch_from_peers",
    "flash_attention",
    "from_env",
    "fused_cross_entropy",
    "fused_linear_cross_entropy",
    "gpt2_small",
    "gpt2_tiny",
    "grad_norm_from_state",
    "init_family",
    "init_gpt2",
    "init_llama",
    "instrument_optimizer",
    "llama_8b",
    "llama_tiny",
    "logit_gate",
    "make_bert_train_step",
    "make_classifier_train_step",
    "make_diffusion_train_step",
    "make_lm_train_step",
    "notfinite_streak",
    "paged_decode_attention",
    "param_bytes",
    "params_from_jax",
    "parse_traceparent",
    "pick_chunk",
    "policy",
    "quantize_kv_rows",
    "quantize_model",
    "reset_launch_counts",
    "resnet18_ish",
    "resnet50",
    "skipped_updates",
    "top_k_routing",
    "unet_small",
    "unet_tiny",
]
