"""The port's attention ops against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both sides. On the
CPU the port's public functions take their plain PyTorch versions; the
JAX side runs its Pallas kernels through the interpreter and its jnp
references. The CUDA kernels themselves are held against the plain
versions by tests/test_torch_kernels_cuda.py (on a card) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.ops.attention import (  # noqa: E402
    _flash_attention_tpu,
    _paged_decode_reference,
    _paged_decode_tpu,
    _reference_attention,
)
from move2kube_tpu_torch.ops import attention as tatt  # noqa: E402

# fp32 atol for attention outputs of O(1) values: both sides accumulate in
# fp32, in different orders (the same bound as tests/test_models.py)
FP32_ATOL = 1e-4
# bf16 inputs: bounded by bf16 output resolution (tests/test_models.py)
BF16_ATOL = 2e-2
# paged decode, fp32 (the bound tests/test_serving.py holds the Pallas
# kernel to)
PAGED_TOL = 2e-5


def _qkv(seed, b, s, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,sk,causal", [
    (256, 256, True), (256, 256, False), (256, 128, False)])
def test_plain_flash_matches_jax_fp32(s, sk, causal):
    b, h, d = 2, 4, 64
    q, k, v = _qkv(0, b, s, sk, h, h, d)
    scale = d ** -0.5
    ours = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kernel = np.asarray(_flash_attention_tpu(jq, jk, jv, causal, scale,
                                             interpret=True))
    ref = np.asarray(_reference_attention(jq, jk, jv, causal, scale))
    np.testing.assert_allclose(ours, kernel, atol=FP32_ATOL)
    np.testing.assert_allclose(ours, ref, atol=FP32_ATOL)


def test_plain_flash_matches_jax_bf16():
    b, s, h, d = 2, 256, 4, 64
    q, k, v = _qkv(1, b, s, s, h, h, d)
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    ours = tatt.flash_attention(tq, tk, tv, causal=True)
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    kernel = _flash_attention_tpu(jq, jk, jv, True, scale, interpret=True)
    ref = _reference_attention(jq, jk, jv, True, scale)
    ours32 = ours.float().numpy()
    np.testing.assert_allclose(ours32, np.asarray(kernel, np.float32),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(ours32, np.asarray(ref, np.float32),
                               atol=BF16_ATOL)


def test_flash_gqa_reads_kv_head_i_div_rep():
    """K/V with fewer heads equal jnp.repeat(k, rep, axis=2) (query head i
    reads KV head i // rep, not i % kvh)."""
    b, s, h, kvh, d = 1, 40, 8, 2, 32
    q, k, v = _qkv(2, b, s, s, h, kvh, d)
    ours = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True).numpy()
    rep = h // kvh
    jk = jnp.repeat(jnp.asarray(k), rep, axis=2)
    jv = jnp.repeat(jnp.asarray(v), rep, axis=2)
    ref = np.asarray(_reference_attention(jnp.asarray(q), jk, jv, True,
                                          d ** -0.5))
    np.testing.assert_allclose(ours, ref, atol=FP32_ATOL)
    # and not the other order
    wrong = np.asarray(_reference_attention(
        jnp.asarray(q), jnp.tile(jnp.asarray(k), (1, 1, rep, 1)),
        jnp.tile(jnp.asarray(v), (1, 1, rep, 1)), True, d ** -0.5))
    assert np.abs(ours - wrong).max() > 1e-2


def _paged_inputs(seed=0):
    """The tests/test_serving.py shapes: 4 query heads over 2 KV heads,
    head_dim 128, pages of 8, partial / page-crossing / full sequences."""
    b, h, kvh, d, bs, mpps, npages = 3, 4, 2, 128, 8, 4, 13
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k_pages = rng.standard_normal((npages, bs, kvh, d)).astype(np.float32)
    v_pages = rng.standard_normal((npages, bs, kvh, d)).astype(np.float32)
    tables = np.zeros((b, mpps), np.int32)
    seq_lens = np.array([5, 8 + 3, 4 * 8], np.int32)
    pool = list(range(1, npages))
    for i in range(b):
        n = -(-int(seq_lens[i]) // bs)
        tables[i, :n] = [pool.pop() for _ in range(n)]
    return q, k_pages, v_pages, tables, seq_lens


def test_plain_paged_decode_matches_jax():
    q, kp, vp, tables, seq_lens = _paged_inputs()
    scale = q.shape[-1] ** -0.5
    ours = tatt.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(seq_lens)).numpy()
    args = [jnp.asarray(x) for x in (q, kp, vp, tables, seq_lens)]
    kernel = np.asarray(_paged_decode_tpu(*args, scale=scale,
                                          interpret=True))
    ref = np.asarray(_paged_decode_reference(*args, scale=scale))
    np.testing.assert_allclose(ours, kernel, atol=PAGED_TOL, rtol=PAGED_TOL)
    np.testing.assert_allclose(ours, ref, atol=PAGED_TOL, rtol=PAGED_TOL)


def test_cpu_wrappers_take_plain_path_without_launching():
    tatt.reset_launch_counts()
    q, k, v = _qkv(3, 1, 8, 8, 2, 2, 64)
    tq = torch.from_numpy(q).requires_grad_()
    out = tatt.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                               causal=True)
    out.sum().backward()  # the plain backward
    qp, kp, vp, tables, seq_lens = _paged_inputs()
    tatt.paged_decode_attention(
        torch.from_numpy(qp), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(seq_lens))
    k8, ks = tatt.quantize_kv_rows(torch.from_numpy(kp))
    tatt.paged_decode_attention(
        torch.from_numpy(qp), k8, k8, torch.from_numpy(tables),
        torch.from_numpy(seq_lens), k_scale=ks, v_scale=ks)
    assert len(tatt.KERNELS) == 5
    assert [k.launches for k in tatt.KERNELS] == [0, 0, 0, 0, 0]


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 4, 3, 64)
    k = torch.zeros(1, 4, 2, 64)  # 3 query heads over 2 KV heads
    with pytest.raises(ValueError):
        tatt.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        tatt.paged_decode_attention(torch.zeros(2, 4, 64),
                                    torch.zeros(3, 8, 2, 32),
                                    torch.zeros(3, 8, 2, 32),
                                    torch.zeros(2, 1, dtype=torch.int32),
                                    torch.ones(2, dtype=torch.int32))


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc a launch raises (no warning, no fallback) and counts
    nothing."""
    from move2kube_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    kern = _build.CudaKernel("flash_fwd", "m2kt_flash_fwd", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kern.launch()
    assert kern.launches == 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([kern])


def test_kernel_library_name_follows_its_sources(monkeypatch, tmp_path):
    """The built library's name carries a digest of the kernel's source
    and the shared header: an edit to either rebuilds."""
    import shutil

    from move2kube_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    kern = _build.CudaKernel("paged_decode", "m2kt_paged_decode", [])
    first = kern.library_path()
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("paged_decode-") and first.suffix == ".so"
    assert kern.library_path() == first
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text()
                                     + "\n// edited\n")
    second = kern.library_path()
    assert second != first
    (csrc / "paged_decode.cu").write_text("// edited\n")
    assert kern.library_path() not in (first, second)


def test_cached_build_returns_its_compiler_log(monkeypatch, tmp_path):
    """A library already built is reused without nvcc, and the compiler's
    output (``-Xptxas -v``: registers, spills) kept beside it is still
    returned. Builds land inside the package, never beside it."""
    from move2kube_tpu_torch.ops import _build

    assert _build.BUILD_DIR.is_relative_to(_build.PACKAGE)
    assert "-Xptxas" in _build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    kern = _build.CudaKernel("paged_decode", "m2kt_paged_decode", [])
    lib = kern.library_path()
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info : Used 96 registers")
    started = kern._start_build()
    assert started is None
    assert kern._finish_build(started) == "ptxas info : Used 96 registers"


def test_kernel_sources_are_packaged():
    """Every kernel's source, and the header they share, lies in the
    package's csrc/ (pyproject.toml ships csrc/*.cu and *.cuh)."""
    for kern in tatt.KERNELS:
        assert kern.source.is_file(), kern.source
        assert kern.source.parent.name == "csrc"
    assert sorted(k.source.name for k in tatt.KERNELS) == [
        "flash_bwd_dkv.cu", "flash_bwd_dq.cu", "flash_fwd.cu",
        "paged_decode.cu", "paged_decode_int8.cu"]
    assert (tatt.FLASH_FWD.source.parent / "common.cuh").is_file()
