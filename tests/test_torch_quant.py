"""The port's int8 serving (weights and KV cache) against the JAX
package's ``serving/quant.py`` and its engine."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from move2kube_tpu.models import llama as jllama  # noqa: E402
from move2kube_tpu.serving import engine as jengine  # noqa: E402
from move2kube_tpu.serving import quant as jquant  # noqa: E402
from move2kube_tpu_torch.models import llama as tllama  # noqa: E402
from move2kube_tpu_torch.models.convert import (  # noqa: E402
    init_llama,
    params_from_jax,
)
from move2kube_tpu_torch.serving import engine as tengine  # noqa: E402
from move2kube_tpu_torch.serving import quant as tquant  # noqa: E402

# logits, port vs JAX, fp32 on the CPU: tests/test_torch_serving.py's
# engine bound (both sides dequantize to the same fp32 weights and, from
# the same K/V, quantize to the same bits, so only sum order differs)
ENGINE_LOGITS_ATOL = 1e-4
# An int8-kv engine quantizes K/V rows that the two frameworks compute
# with sums in other orders (~1e-7 apart): now and then one value lies on
# a rounding boundary and lands one int8 step apart on the two sides (1 of
# the 32768 cached values in the engine test below). That one step of one
# V value moves the logits of the request reading it by 9.4e-4 there; the
# decode logits are held to 5x that, the caches to such one-step flips in
# at most 0.1 % of their values, and the decode step itself, on one int8
# cache, to ENGINE_LOGITS_ATOL (test_int8_decode_step_matches_jax).
INT8_KV_FLIP_ATOL = 5e-3
INT8_KV_MAX_FLIPS = 1e-3
_LINEARS = ("qkv", "attn_out", "gate_up", "down")


@pytest.fixture(scope="module")
def jax_parts():
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=jnp.float32,
                               attn_impl="flash")
    fmodel = jllama.Llama(jcfg)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    return fmodel, variables


@pytest.fixture(scope="module")
def tcfg():
    return dataclasses.replace(tllama.llama_tiny(), dtype=torch.float32,
                               attn_impl="flash")


@pytest.fixture(scope="module")
def fp_model(jax_parts, tcfg):
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.device_get(jax_parts[1]["params"]), tcfg))
    return model.eval()


# ----------------------------------------------------------------------
# policies
# ----------------------------------------------------------------------


def test_policy_table_matches_jax():
    assert tquant.QUANT_OPTIONS == jquant.QUANT_OPTIONS
    for name in tquant.QUANT_OPTIONS:
        ours, theirs = tquant.policy(name), jquant.policy(name)
        assert (ours.name, ours.quantize_weights, ours.quantize_kv) == (
            theirs.name, theirs.quantize_weights, theirs.quantize_kv)
        assert (ours.cache_dtype is None) == (theirs.cache_dtype is None)
    assert tquant.policy("int8-kv").cache_dtype == torch.int8
    for mod in (tquant, jquant):
        with pytest.raises(ValueError, match="unknown"):
            mod.policy("fp8")


@pytest.mark.parametrize("raw", ["int8-kv", "int8", "bogus", None])
def test_from_env_matches_jax(monkeypatch, raw):
    """``M2KT_SERVE_QUANT``: known names select their policy, an unknown
    one or none selects off, in ``from_env`` and ``EngineConfig``."""
    if raw is None:
        monkeypatch.delenv("M2KT_SERVE_QUANT", raising=False)
    else:
        monkeypatch.setenv("M2KT_SERVE_QUANT", raw)
    assert tquant.from_env().name == jquant.from_env().name
    assert (tengine.EngineConfig.from_env().quant
            == jengine.EngineConfig.from_env().quant
            == (raw if raw in ("int8-kv", "int8") else "off"))
    env = {} if raw is None else {"M2KT_SERVE_QUANT": raw}
    assert (tquant.from_env("int8", env).name
            == jquant.from_env("int8", env).name)


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------


def test_quantize_array_equals_jax_transposed():
    rng = np.random.default_rng(0)
    kernel = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)
    kernel[:, 3] = 0.0  # an all-zero output channel
    theirs = jquant.quantize_array(jnp.asarray(kernel))
    q8, scale = tquant.quantize_array(torch.from_numpy(kernel.T.copy()))
    assert q8.dtype == torch.int8 and scale.dtype == torch.float32
    assert q8.shape == (40, 48) and scale.shape == (40, 1)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(theirs["q8"]).T)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(theirs["scale"]).T)


def test_quantize_model_equals_jax_and_leaves_caller_alone(jax_parts,
                                                           fp_model):
    """Every nn.Linear (the four block projections and the lm-head) holds
    the JAX package's int8 leaves, transposed; the embedding and norms
    are shared, unchanged; the caller's model is untouched."""
    before = {k: v.clone() for k, v in fp_model.state_dict().items()}
    qmodel = tquant.quantize_model(fp_model)
    jq = jax.device_get(jquant.quantize_variables(jax_parts[1])["params"])
    for i in range(qmodel.cfg.num_layers):
        for name in _LINEARS:
            mod = getattr(qmodel.layers[i], name)
            leaf = jq[f"layer_{i}"][name]["kernel"]
            assert isinstance(mod, tquant.QuantLinear)
            assert mod.compute_dtype == torch.float32
            np.testing.assert_array_equal(mod.q8.numpy(), leaf["q8"].T)
            np.testing.assert_array_equal(mod.scale.numpy(),
                                          leaf["scale"].T)
    np.testing.assert_array_equal(qmodel.lm_head.q8.numpy(),
                                  jq["lm_head"]["kernel"]["q8"].T)
    assert qmodel.embed.weight is fp_model.embed.weight
    assert qmodel.final_norm.scale is fp_model.final_norm.scale
    assert not any(isinstance(m, torch.nn.Linear) for m in qmodel.modules())
    # the caller's model: same modules, same values
    assert isinstance(fp_model.layers[0].qkv, torch.nn.Linear)
    after = fp_model.state_dict()
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert (tquant.param_bytes(qmodel)
            < 0.5 * tquant.param_bytes(fp_model))
    # quantizing again changes nothing
    again = tquant.quantize_model(qmodel)
    assert again.layers[0].qkv.q8 is qmodel.layers[0].qkv.q8


def test_quantize_model_keeps_bf16_compute():
    cfg = tllama.llama_tiny()
    qmodel = tquant.quantize_model(init_llama(cfg, seed=0, device="cpu"))
    assert qmodel.layers[0].gate_up.compute_dtype == torch.bfloat16
    assert qmodel.layers[0].gate_up.dequantized().dtype == torch.bfloat16
    assert qmodel.lm_head.compute_dtype == torch.float32
    with torch.inference_mode():
        logits = qmodel(torch.tensor([[3, 4, 5]]))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_quantized_forward_matches_jax(jax_parts, fp_model):
    """A full forward of the quantized model against the JAX model on
    the dequantized int8 tree (what the JAX engine's steps run)."""
    fmodel, variables = jax_parts
    ids = np.random.default_rng(1).integers(1, 500, size=(2, 24))
    qvars = jquant.dequantize_variables(jquant.quantize_variables(variables))
    want = np.asarray(fmodel.apply(qvars, jnp.asarray(ids)))
    with torch.inference_mode():
        got = tquant.quantize_model(fp_model)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ENGINE_LOGITS_ATOL, rtol=0)


def test_params_from_jax_loads_the_int8_tree(jax_parts, tcfg):
    """The JAX package's own quantized tree maps onto a quantized model's
    buffers, replacing whatever they held."""
    jq = jax.device_get(jquant.quantize_variables(jax_parts[1])["params"])
    sd = params_from_jax(jq, tcfg)
    assert sd["layers.0.qkv.q8"].dtype == torch.int8
    assert sd["lm_head.scale"].shape == (tcfg.vocab_size, 1)
    assert not any(k.endswith(".weight") and "embed" not in k for k in sd)
    other = tquant.quantize_model(init_llama(tcfg, seed=1, device="cpu"))
    other.load_state_dict(sd)
    np.testing.assert_array_equal(other.layers[1].down.q8.numpy(),
                                  jq["layer_1"]["down"]["kernel"]["q8"].T)


def test_logit_gate_matches_jax():
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((4, 50)).astype(np.float32)
    got = ref + rng.standard_normal((4, 50)).astype(np.float32) * 0.01
    got[2, 0] += 5.0
    assert tquant.logit_gate(ref, got) == jquant.logit_gate(ref, got)
    with pytest.raises(ValueError):
        tquant.logit_gate(ref, got[:2])


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------


def _requests(mod):
    """tests/test_torch_serving.py's requests."""
    rng = np.random.default_rng(7)
    return [mod.Request("a", rng.integers(1, 500, size=5).tolist(), 6),
            mod.Request("b", rng.integers(1, 500, size=20).tolist(), 4),
            mod.Request("c", rng.integers(1, 500, size=9).tolist(), 5)]


def _engine_pair(fmodel, variables, model, quant):
    geometry = dict(max_batch=2, max_seq=64, block_size=8, buckets=(16, 32))
    jeng = jengine.ServingEngine(fmodel, variables, jengine.EngineConfig(
        async_decode="off", quant=quant, **geometry))
    teng = tengine.ServingEngine(model, tengine.EngineConfig(
        quant=quant, **geometry), device="cpu")
    return jeng, teng


def _assert_engines_agree(jeng, teng):
    """Identical streams; every prefill row (read before any cached int8
    row) within ENGINE_LOGITS_ATOL, decode rows too unless the cache is
    int8; an int8 cache equal to the JAX engine's up to one-step flips."""
    jeng.capture_logits = teng.capture_logits = True
    want = {c.rid: c for c in jeng.run(_requests(jengine))}
    got = {c.rid: c for c in teng.run(_requests(tengine))}
    assert set(got) == set(want) == {"a", "b", "c"}
    int8_kv = teng.cache_cfg.quantized
    for rid, c in got.items():
        assert c.tokens == want[rid].tokens, rid
        rows, jrows = teng.logit_log[rid], jeng.logit_log[rid]
        assert len(rows) == len(jrows) == len(c.tokens)
        for i, (row, jrow) in enumerate(zip(rows, jrows)):
            atol = INT8_KV_FLIP_ATOL if int8_kv and i else ENGINE_LOGITS_ATOL
            np.testing.assert_allclose(row, np.asarray(jrow), atol=atol,
                                       rtol=0, err_msg=f"{rid} token {i}")
    assert teng._allocator.available == teng.cache_cfg.num_pages - 1
    if int8_kv:
        flips = total = 0
        for key in ("k", "v"):
            for ours, theirs in zip(teng._cache[key], jeng._cache[key]):
                d = ours[1:].int().numpy() - np.asarray(theirs)[1:].astype(
                    np.int32)  # page 0 collects padding in any order
                assert np.abs(d).max() <= 1, key
                flips += int((d != 0).sum())
                total += d.size
        assert flips <= INT8_KV_MAX_FLIPS * total, (flips, total)


@pytest.mark.parametrize("quant", ["int8", "int8-kv"])
def test_quant_engine_matches_jax_engine(jax_parts, fp_model, quant):
    """The port's engine quantizes the fp32 model at construction, as the
    JAX engine quantizes its variables: the same greedy streams and the
    same logits, with a compute-dtype cache (int8) or an int8 one."""
    jeng, teng = _engine_pair(*jax_parts, fp_model, quant)
    assert teng.model is not fp_model
    assert isinstance(teng.model.layers[0].qkv, tquant.QuantLinear)
    assert isinstance(fp_model.layers[0].qkv, torch.nn.Linear)
    assert teng.cache_cfg.quantized == (quant == "int8-kv")
    assert ("k_scale" in teng._cache) == (quant == "int8-kv")
    if quant == "int8-kv":
        assert teng._cache["k"][0].dtype == torch.int8
    _assert_engines_agree(jeng, teng)


def test_int8_decode_step_matches_jax(jax_parts, fp_model):
    """One decode step of the quantized model on an int8 cache against the
    JAX model's on the same cache (numpy, from a seed): logits within
    ENGINE_LOGITS_ATOL, and the new token's quantized rows and scales
    written where the JAX step writes them."""
    from move2kube_tpu_torch.ops.attention import quantize_kv_rows

    fmodel, variables = jax_parts
    cfg = fp_model.cfg
    kvh, hd, bs, mb = cfg.num_kv_heads, cfg.head_dim, 8, 4
    rng = np.random.default_rng(9)
    pools = {key: [] for key in ("k", "v", "k_scale", "v_scale")}
    for _ in range(cfg.num_layers):
        for key in ("k", "v"):
            q8, sc = quantize_kv_rows(torch.from_numpy(
                rng.standard_normal((9, bs, kvh, hd)).astype(np.float32)))
            pools[key].append(q8.numpy())
            pools[key + "_scale"].append(sc.numpy())
    bt = np.array([[3, 5, 1, 0], [2, 8, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([21, 9, 0], np.int32)  # row 2 idle, on the null page
    tokens = np.array([17, 311, 0], np.int32)
    jcache = {k: [jnp.asarray(x) for x in v] for k, v in pools.items()}
    tcache = {k: [torch.from_numpy(x.copy()) for x in v]
              for k, v in pools.items()}
    for c, conv in ((jcache, jnp.asarray), (tcache, torch.from_numpy)):
        c["block_tables"] = conv(bt)
        c["seq_lens"] = conv(pos + 1)
    qvars = jquant.dequantize_variables(jquant.quantize_variables(variables))
    want, jout = fmodel.apply(qvars, jnp.asarray(tokens),
                              positions=jnp.asarray(pos), cache=jcache)
    qmodel = tquant.quantize_model(fp_model)
    with torch.inference_mode():
        got, _ = qmodel(torch.from_numpy(tokens), positions=torch.from_numpy(
            pos), cache=tcache)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               atol=ENGINE_LOGITS_ATOL, rtol=0)
    for key in ("k", "v", "k_scale", "v_scale"):
        for layer in range(cfg.num_layers):
            ours = tcache[key][layer].numpy()[1:]
            theirs = np.asarray(jout[key][layer])[1:]
            if key in ("k", "v"):
                np.testing.assert_array_equal(ours, theirs, err_msg=key)
            else:
                np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0,
                                           err_msg=key)
    # row 0's token (position 21) went to offset 5 of its third page
    page = bt[0, 21 // bs]
    assert not np.array_equal(tcache["k"][0][page, 21 % bs].numpy(),
                              pools["k"][0][page, 21 % bs])


def test_engine_on_jax_int8_tree_matches_jax_engine(jax_parts, tcfg):
    """The JAX package's own int8 tree, loaded through params_from_jax
    over a quantized model drawn from another seed, serves the JAX int8-kv
    engine's streams (the engine leaves already-quantized layers as they
    are)."""
    jq = jax.device_get(jquant.quantize_variables(jax_parts[1])["params"])
    model = tquant.quantize_model(init_llama(tcfg, seed=1, device="cpu"))
    model.load_state_dict(params_from_jax(jq, tcfg))
    jeng, teng = _engine_pair(*jax_parts, model.eval(), "int8-kv")
    assert teng.model.layers[0].qkv.q8 is model.layers[0].qkv.q8
    _assert_engines_agree(jeng, teng)
