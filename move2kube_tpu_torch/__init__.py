"""PyTorch + CUDA port of move2kube_tpu's compute runtime.

The first slice carries the synchronous serving path of the Llama
engine: the model (:mod:`.models.llama`), its weights
(:mod:`.models.convert`), the paged KV cache (:mod:`.serving.kvcache`)
and the continuous-batching engine (:mod:`.serving.engine`), with
attention in two hand-written CUDA kernels (:mod:`.ops.attention`).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from move2kube_tpu_torch.models.convert import init_llama, params_from_jax
from move2kube_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    llama_8b,
    llama_tiny,
)
from move2kube_tpu_torch.ops.attention import (
    KERNELS,
    flash_attention,
    paged_decode_attention,
    reset_launch_counts,
)
from move2kube_tpu_torch.serving.engine import (
    Completion,
    EngineConfig,
    Request,
    ServingEngine,
)

__all__ = [
    "Completion",
    "EngineConfig",
    "KERNELS",
    "Llama",
    "LlamaConfig",
    "Request",
    "ServingEngine",
    "flash_attention",
    "init_llama",
    "llama_8b",
    "llama_tiny",
    "paged_decode_attention",
    "params_from_jax",
    "reset_launch_counts",
]
