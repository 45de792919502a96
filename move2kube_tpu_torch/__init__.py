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
Training: the LM step (:mod:`.models.train`) with fp32 master weights,
on one card or a mesh of data and fsdp (ZeRO-3) ranks
(:mod:`.parallel`, :func:`create_sharded_state`), the family steps, the
precision policies
(:mod:`.models.precision`) and the head-folded chunked cross-entropy
(:mod:`.ops.crossentropy`). Attention
runs in hand-written CUDA kernels (:mod:`.ops.attention`): the flash
forward, its two backward kernels, and paged decode over fp/bf16 and over
int8 pages. Data, checkpoints and resilience: the host-sharded loader
with its pinned, side-stream prefetch (:mod:`.models.data`), step
checkpoints with the corrupt-latest fallback
(:mod:`.models.checkpoint`), the kernel build cache
(:mod:`.models.compile_cache`), and the supervisor, fault injection,
goodput ledger and preemption watcher (:mod:`.resilience`). Emission:
the HuggingFace and torchvision weight converters (:mod:`.models.convert`),
the emitter of an image's payload for a planned GPU workload
(:func:`emit_container`, :mod:`.containerizer.cuda_emit`) with the
one-GPU trainer and server programs and weight porter it renders
(``assets/cuda``), the fleet's demand forecast, predictive autoscaler,
simulator and usage capture (:mod:`.serving.fleet`), and the
numerics-diff harness (:func:`validate_translation`). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from move2kube_tpu_torch.models.bert import (
    BertConfig,
    BertEncoder,
    bert_base,
    bert_tiny,
)
from move2kube_tpu_torch.models.checkpoint import (
    CheckpointManager,
    restore_variables,
)
from move2kube_tpu_torch.models.compile_cache import (
    bake_prewarm,
    seed_from_prewarm,
    setup_compilation_cache,
    topology_fingerprint,
)
from move2kube_tpu_torch.models.convert import (
    bert_params_from_torch,
    gpt2_params_from_torch,
    infer_num_layers,
    init_family,
    init_gpt2,
    init_llama,
    llama_params_from_torch,
    params_from_jax,
    resnet_params_from_torch,
)
from move2kube_tpu_torch.models.data import (
    AccumLoader,
    HostShardedLoader,
    PrefetchLoader,
    load_arrays,
    make_loader,
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
    create_sharded_state,
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
from move2kube_tpu_torch.resilience import (
    GoodputTracker,
    PreemptionWatcher,
    maybe_inject,
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

# the translate-time layers above the runtime: loaded on first use, so
# the programs an image runs do not import what rendered them
_LAZY = {"emit_container": "move2kube_tpu_torch.containerizer.cuda_emit",
         "validate_translation": "move2kube_tpu_torch.validate"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AccumLoader",
    "AdapterStore",
    "AdmissionController",
    "BertConfig",
    "BertEncoder",
    "CheckpointManager",
    "Completion",
    "DeadlineExceeded",
    "DisaggPair",
    "EngineConfig",
    "EngineDraining",
    "FlashAttention",
    "GPT2",
    "GPT2Config",
    "GoodputTracker",
    "HostShardedLoader",
    "InProcessReplica",
    "KERNELS",
    "KVHandoff",
    "Llama",
    "LlamaConfig",
    "MoEMlp",
    "Optimizer",
    "PrecisionPolicy",
    "PreemptionWatcher",
    "PrefetchLoader",
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
    "bake_prewarm",
    "create_sharded_state",
    "bert_base",
    "bert_params_from_torch",
    "bert_tiny",
    "build_fleet",
    "ddpm_alpha_bars",
    "default_optimizer",
    "default_registry",
    "draft_config",
    "draft_model_from",
    "emit_container",
    "fetch_from_peers",
    "flash_attention",
    "from_env",
    "fused_cross_entropy",
    "fused_linear_cross_entropy",
    "gpt2_params_from_torch",
    "gpt2_small",
    "gpt2_tiny",
    "grad_norm_from_state",
    "infer_num_layers",
    "init_family",
    "init_gpt2",
    "init_llama",
    "instrument_optimizer",
    "llama_8b",
    "llama_params_from_torch",
    "llama_tiny",
    "load_arrays",
    "logit_gate",
    "make_bert_train_step",
    "make_classifier_train_step",
    "make_diffusion_train_step",
    "make_lm_train_step",
    "make_loader",
    "maybe_inject",
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
    "resnet_params_from_torch",
    "restore_variables",
    "seed_from_prewarm",
    "setup_compilation_cache",
    "skipped_updates",
    "top_k_routing",
    "topology_fingerprint",
    "unet_small",
    "unet_tiny",
    "validate_translation",
]
