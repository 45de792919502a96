"""The port's telemetry on a card: the cost model's count of the CUDA
kernels, the tensor-health summaries of CUDA tensors, and ``cost_report``
on a CUDA engine.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from move2kube_tpu_torch.obs import costmodel as tcost  # noqa: E402
from move2kube_tpu_torch.obs import numerics as tnum  # noqa: E402
from move2kube_tpu_torch.obs import tracing as ttracing  # noqa: E402
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d", [(2, 100, 8, 2, 64),
                                         (1, 256, 4, 4, 128)])
def test_flash_flops_through_the_kernels_equal_the_plain_count(
        cuda, dtype, b, s, h, kvh, d):
    """One forward and backward through the kernels counts what the plain
    versions' einsums count on the same CUDA tensors, and each kernel
    launched once under the count."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=cuda,
                           dtype=dtype).requires_grad_()
               for n in (h, kvh, kvh))
    g = torch.randn(b, s, h, d, generator=gen, device=cuda, dtype=dtype)

    def kernels():
        tatt.flash_attention(q, k, v, causal=True).backward(g)

    def plain():
        o, lse = tatt.reference_attention_lse(q.detach(), k.detach(),
                                              v.detach(), True, d ** -0.5)
        tatt.flash_attention_bwd_reference(q.detach(), k.detach(),
                                           v.detach(), o, lse, g, True,
                                           d ** -0.5)

    tatt.reset_launch_counts()
    _, counted = tcost.count_cost(kernels, device=cuda)
    assert (tatt.FLASH_FWD.launches, tatt.FLASH_BWD_DQ.launches,
            tatt.FLASH_BWD_DKV.launches) == (1, 1, 1)
    _, want = tcost.count_cost(plain, device=cuda)
    assert counted.flops == want.flops == 14 * b * h * s * s * d
    assert counted.peak_hbm_bytes > 0


def test_paged_flops_through_the_kernels_equal_the_plain_count(cuda):
    b, h, kvh, d, bs, mb = 4, 8, 2, 128, 16, 6
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, h, d, generator=gen, device=cuda)
    pages = torch.randn(1 + b * mb, bs, kvh, d, generator=gen, device=cuda)
    bt = torch.arange(1, 1 + b * mb, dtype=torch.int32,
                      device=cuda).reshape(b, mb)
    lens = torch.tensor([1, 17, 50, 96], dtype=torch.int32, device=cuda)
    _, counted = tcost.count_cost(
        tatt.paged_decode_attention, q, pages, pages, bt, lens, device=cuda)
    _, want = tcost.count_cost(
        tatt.paged_decode_reference, q, pages, pages, bt, lens, d ** -0.5,
        device=cuda)
    assert counted.flops == want.flops == tatt.paged_decode_flops(
        b, h, mb, bs, d)


def test_summaries_of_a_cuda_tree_equal_its_cpu_copy(cuda):
    gen = np.random.default_rng(2)
    tree = {f"layers.{i}.w": torch.from_numpy(gen.standard_normal(
        (64, 33)).astype(np.float32)) for i in range(12)}
    tree["layers.3.w"][5, 5] = float("nan")
    tree["layers.10.w"][0, :4] = float("inf")
    tree["embed.weight"] = torch.from_numpy(gen.standard_normal(
        (128, 16)).astype(np.float32)).bfloat16()
    tree["layers.0.steps"] = torch.arange(5, dtype=torch.int32)
    names, groups = tnum.group_index(tree)
    on_cpu = tnum.summarize_tree(list(tree.values()), groups, len(names))
    on_card = tnum.summarize_tree([t.to(cuda) for t in tree.values()],
                                  groups, len(names))
    assert all(t.device.type == "cuda" for t in on_card)
    torch.testing.assert_close(on_card[0].cpu(), on_cpu[0], rtol=1e-6,
                               atol=0)
    assert torch.equal(on_card[1].cpu(), on_cpu[1])
    assert torch.equal(on_card[2].cpu(), on_cpu[2])
    doc = tnum.summary(names, tnum.TensorHealthState(*on_card, *on_card))
    assert tnum.first_bad_group(doc) == "layers"


def test_cost_report_on_a_cuda_engine_leaves_the_streams(cuda):
    from move2kube_tpu_torch import (
        EngineConfig,
        Request,
        ServingEngine,
        init_llama,
        llama_tiny,
    )

    cfg = dataclasses.replace(llama_tiny(), d_model=256, attn_impl="flash")
    model = init_llama(cfg, seed=0, device=cuda, dtype=torch.float32).eval()
    gen = np.random.default_rng(3)
    reqs = [Request(f"r{i}", gen.integers(1, 500, size=n).tolist(), 8)
            for i, n in enumerate((5, 20))]
    for quant in ("off", "int8-kv"):
        econf = EngineConfig(max_batch=2, max_seq=64, block_size=8,
                             buckets=(16, 32), quant=quant)
        want = {c.rid: c.tokens for c in ServingEngine(
            model, econf, device=cuda,
            tracer=ttracing.SpanRecorder()).run(reqs)}
        eng = ServingEngine(model, econf, device=cuda,
                            tracer=ttracing.SpanRecorder())
        for r in reqs:
            eng.submit(r)
        done = eng.step() + eng.step()
        passes = dict(eng.stats()["passes"])
        seq_lens = eng._cache["seq_lens"].clone()
        pools = [t.clone() for t in eng._cache["k"]]
        tatt.reset_launch_counts()
        report = eng.cost_report()
        paged = (tatt.PAGED_DECODE_INT8 if quant == "int8-kv"
                 else tatt.PAGED_DECODE)
        assert tatt.FLASH_FWD.launches == cfg.num_layers * len(eng.buckets)
        assert paged.launches == cfg.num_layers
        assert eng.stats()["passes"] == passes
        assert torch.equal(eng._cache["seq_lens"], seq_lens)
        assert all(torch.equal(a, b) for a, b in zip(pools,
                                                     eng._cache["k"]))
        assert report["decode"]["flops"] > 0
        assert report["decode"]["peak_hbm_bytes"] > 0
        while eng.has_work():
            done += eng.step()
        assert {c.rid: c.tokens for c in done} == want
