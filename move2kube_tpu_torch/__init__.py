"""PyTorch + CUDA port of move2kube_tpu's compute runtime.

Three slices are ported. Serving: the synchronous paged-KV path of the
Llama engine, the model (:mod:`.models.llama`), its weights
(:mod:`.models.convert`), the paged KV cache (:mod:`.serving.kvcache`) and
the continuous-batching engine (:mod:`.serving.engine`). int8 serving:
the quant policies, int8 weights dequantized inside each step
(:mod:`.serving.quant`) and the int8 paged KV cache with per-row scales.
Training: the
single-device Llama LM step (:mod:`.models.train`) with fp32 master
weights, the precision policies (:mod:`.models.precision`) and the
head-folded chunked cross-entropy (:mod:`.ops.crossentropy`). Attention
runs in hand-written CUDA kernels (:mod:`.ops.attention`): the flash
forward, its two backward kernels, and paged decode over fp/bf16 and over
int8 pages. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from move2kube_tpu_torch.models.convert import init_llama, params_from_jax
from move2kube_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    llama_8b,
    llama_tiny,
)
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
    make_lm_train_step,
)
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
    EngineConfig,
    Request,
    ServingEngine,
)
from move2kube_tpu_torch.serving.quant import (
    QUANT_OPTIONS,
    QuantLinear,
    QuantPolicy,
    logit_gate,
    param_bytes,
    quantize_model,
)

__all__ = [
    "Completion",
    "EngineConfig",
    "FlashAttention",
    "KERNELS",
    "Llama",
    "LlamaConfig",
    "Optimizer",
    "PrecisionPolicy",
    "QUANT_OPTIONS",
    "QuantLinear",
    "QuantPolicy",
    "Request",
    "ServingEngine",
    "TrainState",
    "adam",
    "adamw",
    "default_optimizer",
    "flash_attention",
    "from_env",
    "fused_cross_entropy",
    "fused_linear_cross_entropy",
    "grad_norm_from_state",
    "init_llama",
    "instrument_optimizer",
    "llama_8b",
    "llama_tiny",
    "logit_gate",
    "make_lm_train_step",
    "notfinite_streak",
    "paged_decode_attention",
    "param_bytes",
    "params_from_jax",
    "pick_chunk",
    "policy",
    "quantize_kv_rows",
    "quantize_model",
    "reset_launch_counts",
    "skipped_updates",
]
