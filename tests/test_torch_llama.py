"""The port's Llama against the flax Llama, on the same weights.

The flax model is initialised from a seed; ``params_from_jax`` carries its
parameters (as numpy) into the torch model. Everything runs on the CPU in
fp32, where the port takes its plain attention paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import (  # noqa: E402
    init_llama,
    params_from_jax,
)
from move2kube_tpu_torch.serving import kvcache  # noqa: E402

# full-forward logits, port vs flax, fp32: two frameworks' matmul and
# transcendental kernels, summed in different orders over 2 layers
LOGITS_ATOL = 1e-4
# paged decode vs the port's own full forward, fp32 (the bound
# tests/test_serving.py holds the JAX engine to)
DECODE_ATOL = 1e-5


def _pair(attn_impl, seed=0):
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl=attn_impl)
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl=attn_impl)
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(variables["params"]), tcfg))
    return fmodel, variables, model.eval()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_full_forward_matches_flax(attn_impl):
    fmodel, variables, model = _pair(attn_impl)
    ids = np.random.default_rng(0).integers(1, 500, size=(2, 24))
    want = np.asarray(fmodel.apply(variables, jnp.asarray(ids, jnp.int32)))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_prefill_kv_matches_flax(attn_impl):
    fmodel, variables, model = _pair(attn_impl, seed=1)
    ids = np.random.default_rng(1).integers(1, 500, size=(1, 12))
    _, jkvs = fmodel.apply(variables, jnp.asarray(ids, jnp.int32),
                           return_kv=True)
    with torch.inference_mode():
        _, kvs = model(torch.from_numpy(ids), return_kv=True)
    assert len(kvs) == len(jkvs)
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        assert k.shape == jk.shape and v.shape == jv.shape
        np.testing.assert_allclose(k.numpy(), np.asarray(jk),
                                   atol=LOGITS_ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                   atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_prefill_then_paged_decode_matches_full_forward(attn_impl):
    """Prompt of 6 in pages of 8, then 3 decode steps that cross into the
    second page: each step's logits equal the full forward's row at that
    position. Slot 0 idles at the null page, as the engine's idle rows
    do."""
    _, _, model = _pair(attn_impl, seed=2)
    block_size, n_steps = 8, 3
    spec = kvcache.spec_for_model(model.cfg, block_size=block_size,
                                  max_batch=2, max_seq=64)
    cache = kvcache.init_cache(spec, "cpu")
    alloc = kvcache.PageAllocator(spec.num_pages)
    prompt = np.random.default_rng(3).integers(1, 500, size=6).tolist()
    plen = len(prompt)
    pages = alloc.alloc(kvcache.pages_for(plen + n_steps, block_size))
    bt_row = torch.full((spec.max_pages_per_seq,), kvcache.NULL_PAGE,
                        dtype=torch.int32)
    bt_row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
    toks = list(prompt)
    paged = []
    with torch.inference_mode():
        logits, kvs = model(torch.tensor([prompt]), return_kv=True)
        kvcache.scatter_prefill(cache, kvs, 1, bt_row, plen, block_size)
        toks.append(int(torch.argmax(logits[0, -1])))
        for _ in range(n_steps):
            pos = torch.tensor([0, len(toks) - 1], dtype=torch.int32)
            model_cache = {
                "k": cache["k"], "v": cache["v"],
                "block_tables": torch.stack(
                    [torch.zeros_like(bt_row), cache["block_tables"][1]]),
                "seq_lens": pos + 1,
            }
            step_logits, _ = model(torch.tensor([0, toks[-1]]),
                                   positions=pos, cache=model_cache)
            paged.append(step_logits[1])
            toks.append(int(torch.argmax(step_logits[1])))
        full = model(torch.tensor([toks]))
    for i, row in enumerate(paged):
        np.testing.assert_allclose(row.numpy(), full[0, plen + i].numpy(),
                                   atol=DECODE_ATOL, rtol=DECODE_ATOL,
                                   err_msg=f"{attn_impl} decode step {i}")


def test_params_from_jax_layout():
    """Dense kernels [in, out] turn into Linear weights [out, in]; fused
    projections stay fused; norms and the lm-head stay fp32 when the
    matrices are bf16."""
    _, variables, _ = _pair("dense")
    p = jax.device_get(variables["params"])
    cfg = dataclasses.replace(tllama.llama_tiny(), dtype=torch.bfloat16)
    sd = params_from_jax(p, cfg)
    qkv = p["layer_0"]["qkv"]["kernel"]
    assert sd["layers.0.qkv.weight"].shape == (qkv.shape[1], qkv.shape[0])
    np.testing.assert_array_equal(
        sd["layers.1.down.weight"].float().numpy(),
        np.asarray(jnp.asarray(p["layer_1"]["down"]["kernel"].T,
                               jnp.bfloat16), np.float32))
    assert sd["layers.0.gate_up.weight"].dtype == torch.bfloat16
    assert sd["embed.weight"].dtype == torch.bfloat16
    assert sd["final_norm.scale"].dtype == torch.float32
    assert sd["layers.0.attn_norm.scale"].dtype == torch.float32
    assert sd["lm_head.weight"].dtype == torch.float32
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(sd)  # strict: every key present, no extras


def test_init_llama_follows_flax_distributions():
    """init_llama draws from flax's default initialisers: the spread of
    each matrix matches the flax model's for the same shapes (the draws
    themselves differ), norms are ones, and one seed gives one model."""
    cfg = dataclasses.replace(tllama.llama_tiny(), vocab_size=2048,
                              d_model=256, mlp_dim=512)
    model = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
    again = init_llama(cfg, seed=0, device="cpu", dtype=torch.float32)
    other = init_llama(cfg, seed=1, device="cpu", dtype=torch.float32)
    jcfg = dataclasses.replace(jllama.llama_tiny(), vocab_size=2048,
                               d_model=256, mlp_dim=512, dtype=jnp.float32)
    fp = jax.device_get(jllama.Llama(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    sd = model.state_dict()
    pairs = {
        "embed.weight": fp["embed"]["embedding"],
        "layers.0.qkv.weight": fp["layer_0"]["qkv"]["kernel"],
        "layers.0.down.weight": fp["layer_0"]["down"]["kernel"],
        "lm_head.weight": fp["lm_head"]["kernel"],
    }
    for name, ref in pairs.items():
        got = sd[name].numpy()
        # std of >= 32k draws: within 5% of flax's
        assert abs(got.std() / np.std(ref) - 1) < 0.05, name
        # truncated at 2 std for Dense, untruncated normal for Embed
        tail = np.abs(got).max() > 2.5 * got.std()
        assert tail == (name == "embed.weight"), name
    assert torch.equal(sd["layers.1.mlp_norm.scale"],
                       torch.ones(cfg.d_model))
    for name, t in again.state_dict().items():
        assert torch.equal(t, sd[name]), name
    assert not torch.equal(other.state_dict()["layers.0.qkv.weight"],
                           sd["layers.0.qkv.weight"])
    bf = init_llama(cfg, seed=0, device="cpu")
    assert bf.layers[0].qkv.weight.dtype == torch.bfloat16
    assert bf.lm_head.weight.dtype == torch.float32


@pytest.mark.parametrize("change,exc", [
    (dict(moe_experts=4), NotImplementedError),
    (dict(attn_impl="ring"), NotImplementedError),
    (dict(attn_impl="ulysses"), NotImplementedError),
    (dict(attn_impl="sparse"), ValueError),
])
def test_unported_configs_raise(change, exc):
    cfg = dataclasses.replace(tllama.llama_tiny(), **change)
    with pytest.raises(exc):
        tllama.Llama(cfg, device="cpu")


def test_lora_delta_is_not_ported():
    model = tllama.Llama(tllama.llama_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        model(torch.zeros(1, 4, dtype=torch.long), lora=(None, None, None))


def test_llama_8b_widths_match_jax():
    ours, theirs = tllama.llama_8b(), jllama.llama_8b()
    for field in ("vocab_size", "d_model", "num_layers", "num_heads",
                  "num_kv_heads", "mlp_dim", "max_len", "rope_theta",
                  "norm_eps"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.head_dim == 128
    assert ours.dtype == torch.bfloat16
