"""The port's data, checkpoint and build-cache paths on a card: the
prefetch loader's pinned buffers and side stream, a checkpoint of CUDA
tensors restored onto the card, and a build directory seeded from a
prewarm artifact loading every kernel without ``nvcc``.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_resilience_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from move2kube_tpu_torch.models import checkpoint as tckpt  # noqa: E402
from move2kube_tpu_torch.models import compile_cache as tcc  # noqa: E402
from move2kube_tpu_torch.models import data as tdata  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models import train as ttrain  # noqa: E402
from move2kube_tpu_torch.models.convert import init_llama  # noqa: E402
from move2kube_tpu_torch.ops import _build  # noqa: E402
from move2kube_tpu_torch.ops.attention import KERNELS  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _arrays(n=96, seq=512):
    rng = np.random.default_rng(3)
    return {"input_ids": rng.integers(0, 32000, (n, seq)).astype(np.int64),
            "label": np.arange(n, dtype=np.int64)}


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_on_a_side_stream_equals_the_sync_loader(cuda, depth):
    """Batches copied through the pinned ring on the side stream equal the
    synchronous loader's, also when the consumer's stream is busy while
    the pump overwrites pinned buffers (more batches than buffers), and
    each handed-out batch stays intact until read."""
    arrays = _arrays()
    sync = tdata.HostShardedLoader(dict(arrays), 8, seed=2, device=cuda)
    want = [next(sync) for _ in range(30)]
    with tdata.PrefetchLoader(tdata.HostShardedLoader(dict(arrays), 8,
                                                      seed=2),
                              depth=depth, device=cuda) as pre:
        got = []
        for _ in range(30):
            batch = next(pre)
            # keep the consumer's stream busy so a premature reuse of the
            # batch's memory or of its pinned buffer would show
            big = torch.randn(2048, 2048, device=cuda)
            for _ in range(4):
                big = big @ big / 2048.0
            got.append({k: v * 1 for k, v in batch.items()})
        torch.cuda.synchronize()
    for w, g in zip(want, got):
        for k in w:
            assert g[k].is_cuda and torch.equal(g[k], w[k])


def test_make_loader_on_the_card_skips_and_counts(cuda, tmp_path):
    np.savez(tmp_path / "t.npz", **_arrays(n=40, seq=64))
    direct = tdata.HostShardedLoader(tdata.load_arrays(
        str(tmp_path / "t.npz")), 4, device=cuda)
    direct.skip(3)
    with tdata.make_loader(str(tmp_path / "t.npz"), 4) as loader:
        loader.skip(3)
        batch = next(loader)
        assert loader.position() == 4
        assert batch["input_ids"].device.type == "cuda"
        assert torch.equal(batch["input_ids"], next(direct)["input_ids"])


def test_cuda_state_roundtrips_onto_the_card(cuda, tmp_path):
    # head_dim 64: a width the kernels take
    cfg = dataclasses.replace(tllama.llama_tiny(), d_model=256,
                              attn_impl="flash")
    model = init_llama(cfg, seed=0, device=cuda, dtype=torch.float32)
    state = ttrain.TrainState(model, ttrain.adamw(model.parameters(), 1e-3))
    step = ttrain.make_lm_train_step(remat=True, chunk=128)
    ids = torch.randint(0, 512, (2, 64), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    for _ in range(2):
        state, _ = step(state, {"input_ids": ids})
    mngr = tckpt.CheckpointManager(str(tmp_path), every=2)
    assert mngr.maybe_save(2, state)
    mngr.close()
    pinned = dict(mngr._pinned)
    assert pinned and all(t.is_pinned() for t in pinned.values())
    state, _ = step(state, {"input_ids": ids})
    assert mngr.maybe_save(4, state, force=True)  # the buffers are reused
    mngr.close()
    assert all(mngr._pinned[k] is t for k, t in pinned.items())
    fresh_model = init_llama(cfg, seed=5, device=cuda, dtype=torch.float32)
    fresh = ttrain.TrainState(fresh_model,
                              ttrain.adamw(fresh_model.parameters(), 1e-3))
    restored, start = tckpt.CheckpointManager(str(tmp_path)) \
        .restore_or_init(fresh)
    assert start == 4
    for (n, a), b in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert b.is_cuda and torch.equal(a, b), n
    for a, b in zip(state.optimizer.params(), restored.optimizer.params()):
        sa = state.optimizer.inner.state[a]
        sb = restored.optimizer.inner.state[b]
        for key in ("exp_avg", "exp_avg_sq"):
            assert sb[key].is_cuda and torch.equal(sa[key], sb[key])
    _, la = step(state, {"input_ids": ids})
    _, lb = step(restored, {"input_ids": ids})
    assert torch.equal(la, lb)
    serve = init_llama(cfg, seed=6, device=cuda, dtype=torch.bfloat16)
    serve.load_state_dict(tckpt.restore_variables(str(tmp_path),
                                                  serve.state_dict()))
    for t in serve.state_dict().values():
        assert t.is_cuda


def test_seeded_build_dir_loads_every_kernel_without_nvcc(cuda, tmp_path):
    """Bake every kernel into a prewarm artifact, then seed an empty cache
    from it: fresh kernel objects load all five with no compiler run."""
    prev = _build.set_build_dir(None)
    try:
        baked = tcc.bake_prewarm(str(tmp_path / "prewarm"))
        assert baked == 2 * len(KERNELS)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("M2KT_PREWARM_DIR", str(tmp_path / "prewarm"))
            mp.delenv("M2KT_COMPILE_CACHE", raising=False)
            mp.delenv("M2KT_COMPILE_CACHE_DIR", raising=False)
            path = tcc.setup_compilation_cache(str(tmp_path / "cache"))
        assert path.endswith(tcc.topology_fingerprint())
        fresh = [_build.CudaKernel(k.name, k.symbol, k.argtypes)
                 for k in KERNELS]
        runs = _build.nvcc_runs
        _build.build_all(fresh)
        assert _build.nvcc_runs == runs
        assert all(k._fn is not None for k in fresh)
        assert all(str(k.library_path()).startswith(path) for k in fresh)
    finally:
        _build.set_build_dir(prev)
