"""The port's async decode pipeline on a card: a 2-layer Llama-8B-width
model (d 4096, 32 heads, 8 KV heads, bf16, flash), its synchronous loop
against windows of 4 passes, and the host side of a window's dispatch.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_async_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from move2kube_tpu_torch.models.convert import init_llama  # noqa: E402
from move2kube_tpu_torch.models.llama import llama_8b  # noqa: E402
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402
from move2kube_tpu_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    Request,
    ServingEngine,
)

pytestmark = pytest.mark.cuda
LAYERS = 2
CONFIG = EngineConfig(max_batch=8, max_seq=1024, block_size=16)
# CUDA runtime calls that wait for the stream: a blocking copy makes one
# of them, and under the pipeline it would wait for the window in flight
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpy")


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = dataclasses.replace(llama_8b(), num_layers=LAYERS, max_len=1024,
                              attn_impl="flash")
    return init_llama(cfg, seed=0, device="cuda").eval()


def _requests(vocab, n=12, new=24):
    rng = np.random.default_rng(5)
    return [Request(f"r{i}", rng.integers(1, vocab, size=int(m)).tolist(),
                    new) for i, m in enumerate(rng.integers(16, 600, n))]


def _run(model, **over):
    eng = ServingEngine(model, dataclasses.replace(CONFIG, **over),
                        device="cuda")
    tatt.reset_launch_counts()
    comps = eng.run(_requests(model.cfg.vocab_size))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in tatt.KERNELS}
    return eng, {c.rid: c.tokens for c in comps}, launches


def test_windows_of_4_match_the_sync_loop_and_their_passes(model):
    """Twelve requests on eight slots: the streams of windows of 4 passes
    equal the synchronous loop's, and each run launches the flash kernel
    once a layer a prefill and the paged kernel once a layer a pass."""
    runs = [_run(model, async_decode="off"),
            _run(model, async_decode="on", substeps=4)]
    assert runs[0][1] == runs[1][1]
    for eng, _, launches in runs:
        passes = eng.stats()["passes"]
        want = dict.fromkeys(launches, 0)
        want["flash_fwd"] = LAYERS * (passes["prefill"] + passes["audit"])
        want["paged_decode"] = LAYERS * (passes["decode"] + passes["verify"]
                                         + passes["chunk"])
        assert launches == want
        assert eng._allocator.available == eng.cache_cfg.num_pages - 1
    assert runs[1][0].stats()["passes"]["decode"] == 4 * runs[1][0].stats()[
        "decode_steps"]


def test_dispatch_makes_no_blocking_copy(model):
    """Eight streams seated and two windows in flight; four more engine
    steps (each consumes one window and dispatches the next, no
    admission) make no CUDA call that waits for the stream: the window's
    inputs go through pinned staging buffers and its tokens come back
    through an event, so the host never waits behind the window it just
    queued."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServingEngine(model, dataclasses.replace(
        CONFIG, admit_burst=0, async_decode="on", substeps=4), device="cuda")
    rng = np.random.default_rng(6)
    for i in range(8):
        eng.submit(Request(f"s{i}", rng.integers(
            1, model.cfg.vocab_size, size=256).tolist(), 40))
    for _ in range(3):
        eng.step()
    assert len(eng._inflight) == 2

    def calls(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        return {e.key: e.count for e in prof.key_averages()}

    # the profiler's own calls (it synchronizes the device as it stops)
    idle = calls(lambda: None)
    names = calls(lambda: [eng.step() for _ in range(4)])
    assert sum(n for k, n in names.items() if k.startswith("cudaLaunch"))
    assert {k: names.get(k, 0) for k in BLOCKING_CALLS} == {
        k: idle.get(k, 0) for k in BLOCKING_CALLS}
    while eng.has_work():
        eng.step()
